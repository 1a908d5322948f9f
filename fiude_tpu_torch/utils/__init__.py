from fiude_tpu_torch.utils.history import History
from fiude_tpu_torch.utils.metrics import nll
