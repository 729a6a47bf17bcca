"""Parallelism: the (dp, ens) mesh of ranks and multi-process runs.

Port of ``tsdiff_tpu/parallel``: the mesh toolkit (``parallel/sharding.py``:
data-parallel training over ``dp``, ensemble members split over ``ens``,
over ``torch.distributed`` groups) and multi-process set-up
(``parallel/multihost.py``: the process group, coordinator gating, each
rank's block of the global batch).
"""

from tsdiff_tpu_torch.parallel.sharding import (  # noqa: F401
    Mesh,
    batch_spec,
    make_hybrid_mesh,
    make_mesh,
    replicate,
    replicated_spec,
    shard_batch,
    shard_ensemble_params,
)
from tsdiff_tpu_torch.diffusion.ensemble import make_ensemble_score_fn, stack_params  # noqa: F401
