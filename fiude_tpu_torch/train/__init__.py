from fiude_tpu_torch.train.checkpoint import (
    flat_from_module,
    load_flat,
    load_params,
    load_state_from_flat,
    save_flat,
    save_params,
)
from fiude_tpu_torch.train.losses import (
    TRAINING_INFO,
    AnnealConfig,
    LossConfig,
    compute_loss,
    kl_annealing,
)
from fiude_tpu_torch.train.trainer import Trainer, TrainState, warm_up_lr
from fiude_tpu_torch.train.experiment import (
    adaptive_curriculum_train,
    build_trainer,
    run_experiment,
    run_transfer,
)
