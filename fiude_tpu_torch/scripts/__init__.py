"""The port's command-line entry points, each run as ``python -m
fiude_tpu_torch.scripts.<name>``: the counterparts of ``scripts/run_sweep.py``,
``tune_worker.py``, ``run_transfer.py``, ``make_tuning_grid.py`` and
``rerun_best_tuning.py``, importing no JAX, pandas or ``filelock``.  Each
takes ``--device`` (the card when omitted; with no card and no ``--device
cpu`` it raises)."""
