"""Config-driven model zoo with signature checking.

Counterpart of `pde_policylearning_tpu/models/dispatcher.py` (reference:
neuralop/models/model_dispatcher.py:6 (MODEL_ZOO), :25 (get_model), :65
(dispatch_model)), over the port's FNO family.  `uno` is not ported yet.
"""
from __future__ import annotations

import inspect
import warnings

from .fno import FNO, FNO1d, FNO2d, FNO3d, TFNO, TFNO1d, TFNO2d, TFNO3d
from .uno import UNO

MODEL_ZOO = {
    "uno": UNO,
    "tfno": TFNO,
    "tfno1d": TFNO1d,
    "tfno2d": TFNO2d,
    "tfno3d": TFNO3d,
    "fno": FNO,
    "fno1d": FNO1d,
    "fno2d": FNO2d,
    "fno3d": FNO3d,
}


def register_model(name, ctor):
    MODEL_ZOO[name.lower()] = ctor


def available_models():
    return list(MODEL_ZOO.keys())


def get_model(config):
    """Instantiate the model named by config['arch'] with config[arch]
    kwargs, `in_channels` set from `data_channels` (times the patching
    levels + 1, for the context channels of multigrid patching;
    model_dispatcher.py:25-63).  Further keyword arguments of the port's
    constructors (`device`, `dtype`, `generator`) go in config[arch]."""
    arch = config["arch"].lower()
    if arch not in MODEL_ZOO:
        raise ValueError(
            f"Got config.arch={arch!r}, expected one of {available_models()}")
    config_arch = dict(config.get(arch))
    data_channels = config_arch.pop("data_channels")
    patching_levels = config.get("patching", {}).get("levels", 0)
    if patching_levels:
        data_channels *= patching_levels + 1
    config_arch["in_channels"] = data_channels
    return dispatch_model(MODEL_ZOO[arch], config_arch)


def dispatch_model(model_ctor, config):
    """model_ctor(**config), dropping with a warning every argument that
    is not in its signature (model_dispatcher.py:65-94)."""
    sig = inspect.signature(model_ctor)
    name = getattr(model_ctor, "__name__", str(model_ctor))
    takes_kwargs = any(p.kind is inspect.Parameter.VAR_KEYWORD
                       for p in sig.parameters.values())
    for key in list(config):
        if key not in sig.parameters and not takes_kwargs:
            warnings.warn(
                f"Given argument {key=} that is not in {name}'s signature.")
            config.pop(key)
    return model_ctor(**config)
