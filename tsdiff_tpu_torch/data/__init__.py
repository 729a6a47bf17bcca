from tsdiff_tpu_torch.data.dataset import (  # noqa: F401
    default_buckets,
    load_dataset,
    pick_bucket,
    save_dataset,
    tier_ladder,
)
