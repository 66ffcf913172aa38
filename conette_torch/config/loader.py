"""YAML config composition: defaults lists, groups, expt presets, overrides."""

from __future__ import annotations

import copy
import os
from typing import Any, Iterable

import yaml

DEFAULT_CONF_DIR = os.path.join(os.path.dirname(__file__), "..", "conf")


class DotDict(dict):
    """Nested dict with attribute access."""

    def __getattr__(self, name: str) -> Any:
        try:
            v = self[name]
        except KeyError as err:
            raise AttributeError(name) from err
        return DotDict(v) if isinstance(v, dict) and not isinstance(v, DotDict) else v

    def __setattr__(self, name: str, value: Any) -> None:
        self[name] = value

    def get_path(self, path: str, default: Any = None) -> Any:
        node: Any = self
        for part in path.split("."):
            if not isinstance(node, dict) or part not in node:
                return default
            node = node[part]
        return node


def merge_dicts(base: dict, override: dict) -> dict:
    out = copy.deepcopy(base)
    for k, v in override.items():
        if isinstance(v, dict) and isinstance(out.get(k), dict):
            out[k] = merge_dicts(out[k], v)
        else:
            out[k] = copy.deepcopy(v)
    return out


def _parse_value(raw: str) -> Any:
    try:
        return yaml.safe_load(raw)
    except yaml.YAMLError:
        return raw


def _set_path(cfg: dict, path: str, value: Any) -> None:
    parts = path.split(".")
    node = cfg
    for p in parts[:-1]:
        node = node.setdefault(p, {})
    node[parts[-1]] = value


def parse_overrides(args: Iterable[str]) -> tuple[dict[str, Any], dict[str, Any]]:
    """Split CLI args into (group_selections, key_overrides).

    ``pl=conette`` selects a group option; ``dm.bsize=3`` overrides a key;
    ``expt=[a,b]`` selects expt presets (list or single).
    """
    groups: dict[str, Any] = {}
    keys: dict[str, Any] = {}
    for arg in args:
        if "=" not in arg:
            raise ValueError(f"Invalid override {arg!r} (expected key=value)")
        key, raw = arg.split("=", 1)
        value = _parse_value(raw)
        if "." in key:
            keys[key] = value
        else:
            groups[key] = value
    return groups, keys


def _load_yaml(fpath: str) -> dict:
    with open(fpath) as f:
        return yaml.safe_load(f) or {}


def _load_group(conf_dir: str, group: str, option: str) -> dict:
    """Load ``{group}/{option}.yaml``, composing the option file's own
    ``defaults`` list (hydra-style in-group composition):

    - a plain string entry names a sibling option of the same group, merged
      before the file body (e.g. trainer/lim2 builds on trainer/fit_test);
    - a ``{subgroup: option}`` entry selects ``{group}/{subgroup}/{option}``
      into key ``subgroup`` (e.g. trainer/plugins: slurm);
    - ``override /...`` entries are global-scope (expt) directives and are
      ignored at group scope (handled by ``_apply_expt``).
    """
    fpath = os.path.join(conf_dir, group, f"{option}.yaml")
    if not os.path.isfile(fpath):
        avail = []
        gdir = os.path.join(conf_dir, group)
        if os.path.isdir(gdir):
            avail = sorted(f[:-5] for f in os.listdir(gdir) if f.endswith(".yaml"))
        raise FileNotFoundError(
            f"Unknown option {option!r} for config group {group!r}. "
            f"(available: {avail})"
        )
    body = _load_yaml(fpath)
    defaults = body.pop("defaults", [])
    cfg: dict = {}
    for entry in defaults:
        if isinstance(entry, str):
            if entry == "_self_":
                cfg = merge_dicts(cfg, body)
                body = {}
            else:
                cfg = merge_dicts(cfg, _load_group(conf_dir, group, entry))
            continue
        (key, sub_option), = entry.items()
        if key.startswith("override "):
            continue
        if sub_option in (None, "none") and not os.path.isfile(
            os.path.join(conf_dir, group, key, "none.yaml")
        ):
            cfg.setdefault(key, None)
            continue
        cfg[key] = merge_dicts(
            cfg.get(key) or {},
            _load_group(conf_dir, os.path.join(group, key), str(sub_option)),
        )
    return merge_dicts(cfg, body)


def _apply_expt(conf_dir: str, cfg: dict, option: str) -> dict:
    """Apply an expt preset (hydra ``@package _global_`` semantics,
    reference ``conf/expt/*.yaml``): recursive sibling defaults (the hp_*
    hyperparameter packs), ``override /group[@path]: option`` selections,
    then the preset body merged into the global config."""
    fpath = os.path.join(conf_dir, "expt", f"{option}.yaml")
    if not os.path.isfile(fpath):
        gdir = os.path.join(conf_dir, "expt")
        avail = sorted(
            f[:-5] for f in os.listdir(gdir) if f.endswith(".yaml")
        ) if os.path.isdir(gdir) else []
        raise FileNotFoundError(
            f"Unknown expt preset {option!r}. (available: {avail})"
        )
    body = _load_yaml(fpath)
    defaults = body.pop("defaults", [])
    for entry in defaults:
        if isinstance(entry, str):
            if entry != "_self_":
                cfg = _apply_expt(conf_dir, cfg, entry)  # sibling hp pack
            continue
        (key, sub_option), = entry.items()
        if not key.startswith("override "):
            # non-override entry inside an expt = sibling preset reference
            cfg = _apply_expt(conf_dir, cfg, str(sub_option))
            continue
        target = key.removeprefix("override ").lstrip("/")
        group, _, path = target.partition("@")
        loaded = _load_group(conf_dir, group, str(sub_option))
        if path:
            _set_path(cfg, path, merge_dicts(DotDict(cfg).get_path(path) or {}, loaded))
        else:
            cfg[group] = merge_dicts(cfg.get(group) or {}, loaded)
    return merge_dicts(cfg, body)


_INTERP_RE = None  # compiled lazily


def _resolve_interpolations(cfg: dict) -> dict:
    """OmegaConf-style ``${dotted.path}`` interpolation against the final
    composed config (reference configs use e.g. ``${trainer.max_epochs}``,
    ``${verbose}``, ``${job}`` -- ``utils/hydra.py`` resolvers excluded,
    those are twinned by the run-dir tagger). A full-string reference
    keeps the referent's type; embedded references stringify. Unresolvable
    references raise, matching hydra."""
    global _INTERP_RE
    import re

    if _INTERP_RE is None:
        _INTERP_RE = re.compile(r"\$\{([a-zA-Z0-9_.]+)\}")
    root = DotDict(cfg)
    _MISSING = object()

    def lookup(path: str):
        value = root.get_path(path, _MISSING)
        if value is _MISSING:
            raise KeyError(f"Unresolvable config interpolation ${{{path}}}")
        return value

    def resolve(value, depth=0):
        if depth > 10:
            raise ValueError("config interpolation cycle")
        if isinstance(value, str):
            full = _INTERP_RE.fullmatch(value)
            if full:
                return resolve(lookup(full.group(1)), depth + 1)
            if _INTERP_RE.search(value):
                return _INTERP_RE.sub(
                    lambda m: str(resolve(lookup(m.group(1)), depth + 1)), value
                )
            return value
        if isinstance(value, dict):
            return {k: resolve(v, depth) for k, v in value.items()}
        if isinstance(value, list):
            return [resolve(v, depth) for v in value]
        return value

    return resolve(cfg)


def load_config(
    name: str = "train",
    overrides: Iterable[str] = (),
    conf_dir: str | None = None,
) -> DotDict:
    """Compose ``{conf_dir}/{name}.yaml`` with its defaults list, group
    selections, ``expt`` presets (applied last) and dotted overrides."""
    conf_dir = conf_dir or DEFAULT_CONF_DIR
    root = _load_yaml(os.path.join(conf_dir, f"{name}.yaml"))
    defaults = root.pop("defaults", [])

    group_sel, key_over = parse_overrides(overrides)
    # a dotless override is a group selection only when a config group
    # directory with that name exists; otherwise it's a root-level key
    for key in list(group_sel.keys()):
        if key != "expt" and not os.path.isdir(os.path.join(conf_dir, key)):
            key_over[key] = group_sel.pop(key)
    expt_sel = group_sel.pop("expt", None)

    cfg: dict = {}
    for entry in defaults:
        if isinstance(entry, str):
            if entry == "_self_":
                cfg = merge_dicts(cfg, root)
            continue
        (group_key, option), = entry.items()
        if group_key == "expt":
            continue  # expt applies last
        # `group@path` packages the group option under a config path
        # (reference root defaults: `audio_t@audio_t.train: spec_aug_ratio_emb`,
        # `tok@train_tok: spacy`)
        group, _, pkg_path = group_key.partition("@")
        option = group_sel.pop(group_key, group_sel.pop(group, option) if not pkg_path else option)
        if option in (None, "none") and not os.path.isfile(
            os.path.join(conf_dir, group, "none.yaml")
        ):
            if pkg_path:
                _set_path(cfg, pkg_path, {})
            else:
                cfg.setdefault(group, {})
            continue
        loaded = _load_group(conf_dir, group, str(option))
        if pkg_path:
            _set_path(
                cfg, pkg_path,
                merge_dicts(DotDict(cfg).get_path(pkg_path) or {}, loaded),
            )
        else:
            cfg[group] = merge_dicts(cfg.get(group, {}), loaded)
    if "_self_" not in [e for e in defaults if isinstance(e, str)]:
        cfg = merge_dicts(cfg, root)

    # remaining group selections not in the defaults list
    for group_key, option in group_sel.items():
        group, _, pkg_path = group_key.partition("@")
        loaded = _load_group(conf_dir, group, str(option))
        # `a/b=opt` selects subgroup b of group a into cfg.a.b (hydra
        # nested-group override syntax, e.g. trainer/plugins=slurm)
        dest = pkg_path or (group.replace("/", ".") if "/" in group else "")
        if dest:
            _set_path(
                cfg, dest,
                merge_dicts(DotDict(cfg).get_path(dest) or {}, loaded),
            )
        else:
            cfg[group] = merge_dicts(cfg.get(group, {}), loaded)

    # expt presets (hydra @package _global_ semantics), applied last
    if expt_sel is not None:
        presets = expt_sel if isinstance(expt_sel, list) else [expt_sel]
        for preset in presets:
            cfg = _apply_expt(conf_dir, cfg, str(preset))

    for key, value in key_over.items():
        _set_path(cfg, key, value)
    cfg = _resolve_interpolations(cfg)
    return DotDict(cfg)
