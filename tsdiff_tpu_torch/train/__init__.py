from tsdiff_tpu_torch.train.checkpoint import (  # noqa: F401
    get_checkpoint_path,
    load_checkpoint,
    opt_state_from_checkpoint,
    save_checkpoint,
    select_params,
)
from tsdiff_tpu_torch.train.trainer import (  # noqa: F401
    TrainState,
    get_objective,
    init_train_state,
    make_eval_step,
    make_optimizer,
    make_resident_eval_step,
    make_resident_train_step,
    make_train_step,
)
