"""Problem/Enactor framework: the bulk-synchronous superstep loop.

Counterpart of ``essentials_tpu/framework`` (reference parity:
enactor.hxx, problem.hxx): a host loop over supersteps with one convergence
check per iteration, and the ``Problem`` wrapper (``BfsProblem``,
``SsspProblem``) around an algorithm's init and step.
"""

from essentials_tpu_torch.framework.enactor import (EnactResult,
                                                    default_converged, enact)
from essentials_tpu_torch.framework.problem import (BfsProblem, Problem,
                                                    SsspProblem)

__all__ = ["enact", "EnactResult", "default_converged", "Problem",
           "BfsProblem", "SsspProblem"]
