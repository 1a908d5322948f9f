"""The port's utilities, imported by submodule (``utils.config``,
``utils.history``, ``utils.metrics``, ...).  The package itself imports
nothing, so that ``utils.profiler``, which the serving path imports, comes
without SciPy: ``metrics`` and the data tools behind ``results`` import it,
seconds of a process's start."""
