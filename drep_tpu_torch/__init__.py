"""drep_tpu_torch — dRep's compare/dereplicate pipeline and its genome
index on PyTorch and CUDA.

The PyTorch port of the JAX package ``drep_tpu`` (which stays in the repo
as the reference). Module names mirror ``drep_tpu/`` so each counterpart is
easy to find. The hot kernels are CUDA C++ for Hopper (``csrc/``), built
with nvcc at first use and loaded with ctypes (``ops/_build.py``):

- ``csrc/mash_shared.cu`` — the union-bottom-s Mash shared count per pair
  (the primary compare);
- ``csrc/indicator_mm.cu`` — the exact containment intersection counts,
  0/1 indicator rows multiplied on the int8 tensor cores without the
  indicator reaching device memory (the secondary compare);
- ``csrc/intersect.cu`` — merge-intersect counts of sorted id rows over
  id-range buckets (secondary clusters past the one-shot budget);
- ``csrc/ring_step.cu``, ``csrc/ring_step_mm.cu`` — one step of the
  dense mesh ring, by merge walks or by the indicator product: the
  step's tile and the B operand's copy into the neighbour
  (``parallel/``).

The genome index (``index/``: ``index build|update|classify`` on one
store) drives the Mash kernel over the K x N tail rectangle and the
indicator product over each re-clustered primary cluster.

Every entry point runs on ``cuda`` unless the caller asks for
``device="cpu"`` (CLI: ``--device cpu``); on the CPU each kernel wrapper
runs its plain PyTorch version. Nothing here imports JAX or ``drep_tpu``.
"""

__version__ = "0.1.0"
