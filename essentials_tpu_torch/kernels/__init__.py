"""The port's CUDA kernels: a module per ``csrc/*.cu`` with its wrappers,
their plain versions (the same arithmetic in PyTorch) and their scratch
sizes, and ``_lib``, which builds and loads the library they share. A
wrapper given CPU tensors runs the plain version, given CUDA tensors the
kernel; anything else raises, and there is no fallback from the kernel.

The modules' ``__all__`` are the package's names. A value that a wrapper
reads at call time (``bfs.bfs_level_form``, ``bfs.PRED_SPLIT``,
``operators.gather_packs``, ``operators.PACK_MIN_SLOTS``) is not among them:
it is read and rebound in its own module."""

from ._lib import *  # noqa: F401,F403
from ._lib import _library, _segment_ids  # noqa: F401
from .operators import *  # noqa: F401,F403
from .operators import _wrap_i32  # noqa: F401
from .bfs import *  # noqa: F401,F403
from .spmv import *  # noqa: F401,F403
from .sssp_kcore import *  # noqa: F401,F403
from .tc import *  # noqa: F401,F403
