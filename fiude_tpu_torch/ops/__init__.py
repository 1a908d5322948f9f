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
    FusedForecaster,
    UDEWeights,
    pack_ude,
    trajectory_decode,
    trajectory_decode_plain,
)
