from fiude_tpu_torch.utils.config import (
    ODE_NAMES, REGION_INFO, ExperimentConfig, grid, reference_main_grid,
)
from fiude_tpu_torch.utils.history import History
from fiude_tpu_torch.utils import latent_ode
from fiude_tpu_torch.utils.logging import get_logger
from fiude_tpu_torch.utils.metrics import (
    mae, mb_log, mb_log_torch, nll, nll_torch, skill, skill_torch,
)
from fiude_tpu_torch.utils.results import evaluate_forecast, test_and_record, upsert_results_row
