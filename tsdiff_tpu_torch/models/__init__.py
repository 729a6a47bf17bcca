"""Model registry: ``get_model(config.model)`` dispatches on ``config.network``."""

from tsdiff_tpu_torch.models.condensenc import CondenseEncoderEpsNetwork  # noqa: F401


def get_model(config, dtype=None, generator=None):
    """The network of a model config, its parameters drawn from ``generator``."""
    if config.network == "condensenc":
        return CondenseEncoderEpsNetwork.from_config(config, dtype=dtype, generator=generator)
    if config.network == "dualenc":
        raise NotImplementedError("the dualenc network is not yet ported (ROADMAP §A.7)")
    raise NotImplementedError(f"Unknown network: {config.network}")
