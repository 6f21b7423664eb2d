"""Rank-and-select: the plain versions (``ref``) and the CUDA kernel
(``match``, built by ``build`` from ``csrc/``)."""
