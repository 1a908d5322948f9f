from fiude_tpu_torch.parallel.sweep import (
    PopulationTrainer,
    group_configs_for_population,
    run_population_experiment,
    run_work_queue,
)
