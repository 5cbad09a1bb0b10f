"""Config system: a YAML file deep-merged with dotted CLI overrides
(``dct_tpu/config.py``).

``python -m dct_tpu_torch.train_cotraining Trainer.save_dir=runs/x
StartTraining.train_jsd=True`` parses each positional token ``A.B.C=value``
into a nested dict and merges it recursively over the YAML config. Values
are parsed with ``yaml.safe_load`` (ints, floats, bools, lists, strings),
never ``eval``.
"""
from __future__ import annotations

import argparse
import copy
from pathlib import Path
from typing import Any, Dict, List, Optional

import yaml


def load_yaml(path: str | Path) -> Dict[str, Any]:
    with open(path) as f:
        return yaml.safe_load(f)


def save_yaml(config: Dict[str, Any], path: str | Path) -> None:
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    with open(path, "w") as f:
        yaml.safe_dump(config, f, default_flow_style=False)


def parse_value(raw: str) -> Any:
    """Parse a CLI value string into a python object without eval: ints,
    floats, bools, None, lists and quoted strings as YAML reads them;
    anything unparseable stays a plain string (e.g. bare paths with ':')."""
    try:
        return yaml.safe_load(raw)
    except yaml.YAMLError:
        return raw


def parse_dotted_arg(arg: str) -> Dict[str, Any]:
    """``A.B.C=value`` → ``{'A': {'B': {'C': value}}}``."""
    if "=" not in arg:
        raise ValueError(f"override must look like A.B=value, got {arg!r}")
    keys, raw = arg.split("=", 1)
    value: Any = parse_value(raw)
    out: Dict[str, Any] = {}
    cursor = out
    parts = keys.split(".")
    for key in parts[:-1]:
        cursor[key] = {}
        cursor = cursor[key]
    cursor[parts[-1]] = value
    return out


def dict_merge(base: Dict[str, Any], overrides: Optional[Dict[str, Any]],
               re: bool = True) -> Dict[str, Any]:
    """Recursive merge of ``overrides`` onto ``base`` (returns a new dict):
    nested dicts merge key by key, anything else overwrites."""
    merged = copy.deepcopy(base)
    if overrides is None:
        return merged
    for k, v in overrides.items():
        if k in merged and isinstance(merged[k], dict) and isinstance(v, dict):
            merged[k] = dict_merge(merged[k], v, re)
        else:
            merged[k] = copy.deepcopy(v)
    return merged


def flatten_dict(d: Dict[str, Any], parent_key: str = "", sep: str = ".") -> Dict[str, Any]:
    """Flatten a nested dict into dotted keys."""
    items: List[tuple] = []
    for k, v in d.items():
        new_key = parent_key + sep + k if parent_key else k
        if isinstance(v, dict):
            items.extend(flatten_dict(v, new_key, sep=sep).items())
        else:
            items.append((new_key, v))
    return dict(items)


def yaml_parser(default_config: str, argv: Optional[List[str]] = None,
                verbose: bool = True) -> Dict[str, Any]:
    """Parse ``[--config path] A.B=value ...`` and return the merged config."""
    parser = argparse.ArgumentParser(description="dct_tpu_torch config parser")
    parser.add_argument("--config", type=str, default=default_config,
                        help="path to the base YAML config")
    parser.add_argument("overrides", nargs="*", help="dotted overrides A.B.C=value")
    args = parser.parse_args(argv)

    config = load_yaml(args.config)
    for arg in args.overrides:
        config = dict_merge(config, parse_dotted_arg(arg))
    if verbose:
        print(yaml.safe_dump(config, default_flow_style=False))
    return config
