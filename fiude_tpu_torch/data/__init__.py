from fiude_tpu_torch.data.loader import ArrayLoader
