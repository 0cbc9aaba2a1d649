"""Hand-written Hopper kernels of the port and their dispatch registry.

Importing this package builds nothing; :mod:`repro_torch.kernels.build`
compiles ``csrc/*.cu`` on the first launch.
"""
