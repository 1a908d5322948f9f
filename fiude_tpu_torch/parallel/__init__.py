from fiude_tpu_torch.parallel.mesh import (
    Mesh, config_mesh, data_mesh, make_mesh, sample_data_mesh, shard,
)
from fiude_tpu_torch.parallel.train_step import (
    make_fused_sharded_train_step, make_sharded_forecast, make_sharded_train_step,
)
from fiude_tpu_torch.parallel.serving import ShardedFusedForecaster
from fiude_tpu_torch.parallel.sweep import (
    PopulationTrainer,
    group_configs_for_population,
    run_population_experiment,
    run_work_queue,
)
