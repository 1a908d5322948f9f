from fiude_tpu_torch.data.builder import (
    DataConstructor, choose_qs, get_hhs_query_data, get_nat_query_data, get_state_query_data,
    interpolate_ili, load_ili, smooth, stack_windows,
)
from fiude_tpu_torch.data.loader import ArrayLoader, convert_to_arrays, return_folds
from fiude_tpu_torch.data.synthetic import (
    synthetic_daily_ili, synthetic_dataset, synthetic_queries,
    write_reference_data_tree,
)
from fiude_tpu_torch.data.tables import Frame
