"""PyTorch/CUDA port of the PDP SAT solver (first slice: the classical
p-d-p solve).

The package mirrors the layout of `pdp_solver_tpu` so each module's
counterpart is easy to find. It imports torch and numpy only; the JAX
package is the reference it is tested against, never a dependency.
Entry points run on the CUDA card unless the caller passes a CPU device.
"""
