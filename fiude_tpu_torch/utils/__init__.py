from fiude_tpu_torch.utils.config import (
    ODE_NAMES, REGION_INFO, ExperimentConfig, grid, reference_main_grid,
)
from fiude_tpu_torch.utils.history import History
from fiude_tpu_torch.utils.metrics import mae, mb_log, nll, skill
from fiude_tpu_torch.utils.results import evaluate_forecast, test_and_record, upsert_results_row
