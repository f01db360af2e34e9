"""Problem/Enactor framework: the bulk-synchronous superstep loop.

Counterpart of ``essentials_tpu/framework`` (reference parity:
enactor.hxx): a host loop over supersteps with one convergence check per
iteration. The JAX package's ``problem.py`` (``Problem``, ``BfsProblem``,
``SsspProblem``) has no caller among its algorithms and is not carried.
"""

from essentials_tpu_torch.framework.enactor import (EnactResult,
                                                    default_converged, enact)

__all__ = ["enact", "EnactResult", "default_converged"]
