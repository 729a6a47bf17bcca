from tsdiff_tpu_torch.train.checkpoint import load_checkpoint, select_params  # noqa: F401
