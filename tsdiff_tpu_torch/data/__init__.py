from tsdiff_tpu_torch.data.dataset import (  # noqa: F401
    PaddedBatchLoader,
    TSDataset,
    default_buckets,
    inf_iterator,
    load_dataset,
    pick_bucket,
    save_dataset,
    tier_ladder,
)
