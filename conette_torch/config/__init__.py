"""Lightweight Hydra-style configuration.

The reference composes 68 YAML files with Hydra defaults-lists, group
overrides (``group=option``), dotted key overrides (``a.b=v``) and ``expt``
experiment presets applied last (``src/conf/train.yaml:18-19``, SURVEY.md
§5 "config/flag system"). This module reimplements that composition model
(defaults list → group files → expt presets → CLI overrides) on plain
PyYAML, with no external dependency.
"""

from conette_torch.config.loader import (
    DotDict,
    load_config,
    merge_dicts,
    parse_overrides,
)

__all__ = ["load_config", "parse_overrides", "merge_dicts", "DotDict"]
