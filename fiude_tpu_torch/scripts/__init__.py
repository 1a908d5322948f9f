"""The port's command-line entry points, each run as ``python -m
fiude_tpu_torch.scripts.<name>``: the counterparts of ``scripts/run_sweep.py``,
``tune_worker.py``, ``run_transfer.py``, ``make_tuning_grid.py``,
``rerun_best_tuning.py``, ``tune_encoders.py``, ``demo_accuracy.py``,
``bayes_workflow.py``, ``validate_data_tree.py`` and ``summarize_results.py``,
importing no JAX, pandas, matplotlib or ``filelock``.  Each that trains takes
``--device`` (the card when omitted; with no card and no ``--device cpu`` it
raises); the validator and the summary run on the host."""
