"""Scale-out: process groups, partitioned graphs, distributed supersteps.

Counterpart of ``essentials_tpu/parallel``: 1-D vertex partitions
(``partition``), one process per device over ``torch.distributed``
(``multihost``, ``mesh``), frontier/value exchange by collectives and
convergence by ``all_reduce`` (``distributed``).
"""

from essentials_tpu_torch.parallel.mesh import Mesh, device_count, make_mesh

__all__ = ["Mesh", "make_mesh", "device_count"]
