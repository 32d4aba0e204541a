"""Config system: argparse + YAML merge where YAML wins.

Counterpart of `pde_policylearning_tpu/utils/config.py` (reference:
libs/arguments.py:10-39 (load/merge semantics), libs/models/utils.py:285
(DotDict)); the parser adds `--device` (default: the card).
"""
from __future__ import annotations

import argparse
from typing import Optional

import yaml


class DotDict(dict):
    """dict with attribute access (libs/models/utils.py:285)."""

    def __getattr__(self, name):
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __setattr__(self, name, value):
        self[name] = value

    def __delattr__(self, name):
        del self[name]

    @classmethod
    def wrap(cls, obj):
        if isinstance(obj, dict):
            return cls({k: cls.wrap(v) for k, v in obj.items()})
        if isinstance(obj, (list, tuple)):
            return type(obj)(cls.wrap(v) for v in obj)
        return obj


def load_yaml(path: str) -> DotDict:
    with open(path) as f:
        return DotDict.wrap(yaml.safe_load(f))


def save_yaml(cfg: dict, path: str):
    with open(path, "w") as f:
        yaml.dump(dict(cfg), f)


def merge_args_with_yaml(args: argparse.Namespace,
                         yaml_cfg: dict) -> DotDict:
    """YAML values override CLI args (libs/arguments.py:16-26)."""
    merged = DotDict(vars(args))
    merged.update(yaml_cfg)
    return merged


def parse_and_load(parser: Optional[argparse.ArgumentParser] = None,
                   yaml_arg: str = "train_yaml",
                   argv=None) -> DotDict:
    parser = parser or default_parser()
    args = parser.parse_args(argv)
    cfg = load_yaml(getattr(args, yaml_arg))
    return merge_args_with_yaml(args, cfg)


def default_parser() -> argparse.ArgumentParser:
    """The reference's command line (libs/arguments.py:29-39)."""
    parser = argparse.ArgumentParser(description="Argument Controller")
    parser.add_argument("--control_yaml", type=str,
                        default="configs/base_control.yaml")
    parser.add_argument("--train_yaml", type=str,
                        default="configs/base_fno.yaml")
    parser.add_argument("--set_re", type=int, default=-1)
    parser.add_argument("--set_epoch", type=int, default=-1)
    parser.add_argument("--force_close_wandb", action="store_true")
    parser.add_argument("--device", type=str, default=None,
                        help="torch device to run on (default: the card; "
                        "'cpu' runs the plain versions)")
    return parser
