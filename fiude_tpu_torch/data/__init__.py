from fiude_tpu_torch.data.loader import ArrayLoader
from fiude_tpu_torch.data.synthetic import (
    build_windows, synthetic_daily_ili, synthetic_dataset, synthetic_queries,
)
