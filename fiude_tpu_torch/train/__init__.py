from fiude_tpu_torch.train.checkpoint import (
    flat_from_module,
    load_params,
    load_state_from_flat,
    save_params,
)
