"""Model registry: ``get_model(config.model)`` dispatches on ``config.network``."""

from tsdiff_tpu_torch.models.condensenc import CondenseEncoderEpsNetwork  # noqa: F401
from tsdiff_tpu_torch.models.dualenc import DualEncoderEpsNetwork  # noqa: F401
from tsdiff_tpu_torch.models.edge import (  # noqa: F401
    GaussianSmearingEdgeEncoder,
    MLPEdgeEncoder,
    get_edge_encoder,
)
from tsdiff_tpu_torch.models.schnet import SchNetEncoder  # noqa: F401


def get_model(config, dtype=None, generator=None):
    """The network of a model config, its parameters drawn from ``generator``."""
    if config.network == "condensenc":
        return CondenseEncoderEpsNetwork.from_config(config, dtype=dtype, generator=generator)
    if config.network == "dualenc":
        return DualEncoderEpsNetwork.from_config(config, dtype=dtype, generator=generator)
    raise NotImplementedError(f"Unknown network: {config.network}")
