"""Typed experiment configuration (replaces the reference's inline dicts).

Counterpart of ``fiude_tpu/utils/config.py``, kept as the port's own copy
(pure Python; the port imports nothing of the JAX package).  ``REGION_INFO``
mirrors ``run_ode.py:40-68`` exactly; :class:`ExperimentConfig` is the typed
unit of work consumed by the experiment recipes (one row of the reference's
nested for-loop grid, ``run_ode.py:90-97``).
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Any, Dict, List, Sequence


#: Per-region model presets (reference run_ode.py:40-68).
REGION_INFO: Dict[str, Dict[str, Any]] = {
    "state": {
        "n_regions": 49,
        "latent_dim": 8,
        "n_qs": 8,
        "ode_params": {"net_sizes": (64, 64, 32), "aug_net_sizes": (64, 64),
                       "prior_std": 0.05},
        "dec_params": {},
        "enc_params": {"q_sizes": (256, 128), "ff_sizes": (64, 64),
                       "SIR_scaler": [0.1, 0.05, 1.0]},
        "epochs": 120,
    },
    "hhs": {
        "n_regions": 10,
        "latent_dim": 8,
        "n_qs": 15,
        "ode_params": {"net_sizes": (64, 64, 32), "aug_net_sizes": (64, 64),
                       "prior_std": 0.05},
        "dec_params": {},
        "enc_params": {"q_sizes": (256, 128), "ff_sizes": (64, 64),
                       "SIR_scaler": [0.1, 0.05, 1.0]},
        "epochs": 120,
    },
    "US": {
        "n_regions": 1,
        "latent_dim": 8,
        "n_qs": 90,
        "ode_params": {"net_sizes": (64, 64, 32), "aug_net_sizes": (64, 64),
                       "prior_std": 0.05},
        "dec_params": {},
        "enc_params": {"q_sizes": (256, 128), "ff_sizes": (64, 64),
                       "SIR_scaler": [0.1, 0.05, 1.0]},
        "epochs": 120,
    },
}

ODE_NAMES = ("CONN", "UONN", "SONN", "CONNb", "UONNb", "SONNb")


@dataclasses.dataclass(frozen=True)
class ExperimentConfig:
    """One unit of sweep work (one iteration of run_ode.py:90-97)."""
    region: str = "US"
    ode_name: str = "CONN"
    test_season: int = 2016
    epochs: int = 120
    window_size: int = 28
    gamma: int = 28
    latent_dim: int = 8
    num: int = 0               # replicate/seed id
    lr: float = 1e-3
    batch_size: int = 32
    n_samples: int = 64
    grad_lim: float = 5000.0

    @property
    def key(self) -> str:
        """Stable work-unit id (the reference's file_prefix, run_ode.py:101)."""
        return (f"{self.region}/{self.ode_name}/{self.test_season}"
                f"_e{self.epochs}_g{self.gamma}_w{self.window_size}_{self.num}_")

    @property
    def n_regions(self) -> int:
        return REGION_INFO[self.region]["n_regions"]

    @property
    def n_qs(self) -> int:
        return REGION_INFO[self.region]["n_qs"]

    def model_kwargs(self) -> Dict[str, Any]:
        info = REGION_INFO[self.region]
        return dict(
            n_regions=info["n_regions"], latent_dim=self.latent_dim,
            n_qs=info["n_qs"], ode_name=self.ode_name,
            enc_params=dict(info["enc_params"]),
            ode_params=dict(info["ode_params"]),
            dec_params=dict(info["dec_params"]),
        )

    def as_row(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


def grid(**axes: Sequence) -> List[ExperimentConfig]:
    """Cartesian product of config axes -> list of ExperimentConfig.

    Mirrors the nested loops in run_ode.py:90-97 / the tuning CSV generator
    (tuning/tuning_file_maker.ipynb).
    """
    names = list(axes)
    configs = []
    for values in itertools.product(*(axes[n] for n in names)):
        configs.append(ExperimentConfig(**dict(zip(names, values))))
    return configs


def reference_main_grid() -> List[ExperimentConfig]:
    """The full run_ode.py sweep: 3 regions x 3 epoch counts x 5 windows x
    4 gammas x 5 nums x 4 seasons x 2 models = 7200 configs."""
    return grid(
        region=["US", "hhs", "state"],
        epochs=[140, 200, 260],
        window_size=[1, 8, 15, 22, 29],
        gamma=[35, 42, 49, 56],
        latent_dim=[8],
        num=[15, 16, 17, 18, 19],
        test_season=[2015, 2016, 2017, 2018],
        ode_name=["CONN", "UONN"],
    )
