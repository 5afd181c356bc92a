"""matrel_tpu_torch — the PyTorch / CUDA port of matrel_tpu.

The JAX package ``matrel_tpu`` stays the reference; this package keeps
its module paths and public names so each counterpart is easy to find,
imports ``torch`` and numpy and never ``jax``, and runs on a CUDA device
unless the caller asks for the CPU.
"""

from matrel_tpu_torch.config import MatrelConfig, NotPortedError
from matrel_tpu_torch.core.blockmatrix import BlockMatrix
from matrel_tpu_torch.core.mesh import DeviceUnavailableError, make_mesh
from matrel_tpu_torch.core.sparse import BlockSparseMatrix
from matrel_tpu_torch.session import MatrelSession

__all__ = ["BlockMatrix", "BlockSparseMatrix", "DeviceUnavailableError",
           "MatrelConfig", "MatrelSession", "NotPortedError", "make_mesh"]
