from tsdiff_tpu_torch.models.condensenc import CondenseEncoderEpsNetwork  # noqa: F401
