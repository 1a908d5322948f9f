from fiude_tpu_torch.ops.gru import GRULayer, gru_cell, gru_gates, gru_stack_last
from fiude_tpu_torch.ops.integrate import odeint_grid, rk4_38_step
from fiude_tpu_torch.ops.fused_gru import (
    BackGRUWeights,
    FusedBackGRUEncoder,
    backgru_encode,
    backgru_encode_plain,
    pack_backgru,
)
from fiude_tpu_torch.ops.fused_ude import (
    FieldWeights,
    FusedForecaster,
    UDEWeights,
    pack_field,
    pack_ude,
    trajectory_decode,
    trajectory_decode_plain,
)
from fiude_tpu_torch.ops.fused_gru_train import backgru_train_plain, encode_train
from fiude_tpu_torch.ops.fused_bayes import (
    BayesField,
    BayesWeights,
    FusedBayesForecaster,
    bayes_trajectory_decode,
    bayes_trajectory_decode_plain,
    pack_bayes,
    pack_bayes_field,
)
from fiude_tpu_torch.ops.fused_train import (
    RATE_SHIFT,
    aux_to_model_layout,
    train_trajectory,
    train_trajectory_plain,
    traj_to_model_layout,
)
from fiude_tpu_torch.ops.fused_bayes_train import (
    bayes_train_trajectory,
    bayes_train_trajectory_plain,
)
