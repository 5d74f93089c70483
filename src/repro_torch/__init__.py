"""repro_torch: Distributed Keyword Search (DKS) — relationship queries on
large graphs using the Pregel model, in PyTorch with hand-written CUDA
kernels for NVIDIA Hopper.

The twin of the ``repro`` package (JAX on a TPU): the same graphs go in and
the same answers come out, bit for bit on the min-plus lattice.  It imports
``torch`` and ``numpy`` and nothing of ``repro`` or ``jax``.

Paper: "Relationship Queries on Large graphs using Pregel"
       (Agarwal, Ramanath, Shroff; 2016).
"""

__version__ = "0.1.0"

INF = 1e9  # finite +infinity sentinel: keeps the min-plus algebra total
