"""PyTorch / CUDA port of the campaign simulator's compiled sweep.

``repro_torch`` runs the count-plane Monte-Carlo sweep of the JAX
package's ``engine="jax"`` on an NVIDIA H100, with the per-tick TPU
kernels rewritten as hand-written CUDA kernels (``kernels/csrc``).  It
imports neither JAX nor the JAX package: the two meet through spec JSON
and numpy arrays.  Entry points: :func:`repro_torch.core.api.sweep` and
:func:`repro_torch.core.api.run`.
"""
