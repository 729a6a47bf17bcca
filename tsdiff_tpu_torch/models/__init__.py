"""Model registry: ``get_model(config.model)`` dispatches on
``config.network``; ``load_encoder`` builds an encoder by name."""

from tsdiff_tpu_torch.models.condensenc import CondenseEncoderEpsNetwork  # noqa: F401
from tsdiff_tpu_torch.models.dualenc import DualEncoderEpsNetwork  # noqa: F401
from tsdiff_tpu_torch.models.edge import (  # noqa: F401
    GaussianSmearingEdgeEncoder,
    MLPEdgeEncoder,
    get_edge_encoder,
)
from tsdiff_tpu_torch.models.schnet import SchNetEncoder  # noqa: F401


def _encoders() -> dict:
    """The encoder registry; the optional encoders are imported here, at
    first use."""
    from tsdiff_tpu_torch.models.comenet import ComENetEncoder
    from tsdiff_tpu_torch.models.dimenetpp import DimeNetPPEncoder
    from tsdiff_tpu_torch.models.egnn import EGNNMixed2DEncoder
    from tsdiff_tpu_torch.models.gin import GINEncoder

    return {
        "schnet": SchNetEncoder,
        "gin": GINEncoder,
        "egnn": EGNNMixed2DEncoder,
        "dimenetpp": DimeNetPPEncoder,
        "comenet": ComENetEncoder,
    }


def load_encoder(config, key: str, dtype=None, generator=None):
    """The encoder ``config[key].name`` names (schnet, gin, egnn, dimenetpp,
    comenet), built by its ``from_config`` with parameters drawn from
    ``generator`` (``tsdiff_tpu/models/__init__.py:17-36``)."""
    enc_config = config[key]
    return _encoders()[enc_config.name].from_config(enc_config, dtype=dtype, generator=generator)


def get_model(config, dtype=None, generator=None):
    """The network of a model config, its parameters drawn from ``generator``."""
    if config.network == "condensenc":
        return CondenseEncoderEpsNetwork.from_config(config, dtype=dtype, generator=generator)
    if config.network == "dualenc":
        return DualEncoderEpsNetwork.from_config(config, dtype=dtype, generator=generator)
    raise NotImplementedError(f"Unknown network: {config.network}")
