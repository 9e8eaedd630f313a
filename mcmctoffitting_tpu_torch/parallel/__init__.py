"""Walker sharding over torch.distributed ranks, in place of the
reference's process pools.

``mesh``: the walker mesh and the sharded log-prob evaluators (the
contract they keep is in its docstring).  ``distributed``: joining a
multi-process or multi-host runtime (the MCMCTOF_* variables) and the
global-mesh helpers.  ``launch``: N local ranks in processes of their own.
Port of ``mcmctoffitting_tpu/parallel/``.
"""

from . import distributed  # noqa: F401
from .mesh import (WALKER_AXIS, WalkerMesh, make_mesh,  # noqa: F401
                   make_sharded_logp_batch, make_sharded_pt_batch,
                   replicate)
