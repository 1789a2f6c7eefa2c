"""Hand-written Hopper kernels (``csrc/``), their launchers, their plain
PyTorch versions (``ref``) and the public wrappers (``ops``)."""
