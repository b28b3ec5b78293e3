# -*- coding: utf-8 -*-
"""Hydra-lite YAML config composition: the port of ``climsr_tpu.config.compose``.

The same workflow as the JAX composer (``conf/config.yaml`` defaults list +
``experiment=...`` global overrides + dotted CLI overrides + ``${...}``
interpolation), and the same result:

- ``compose(config_dir, config_name, overrides)`` loads the root file, pulls
  in each ``defaults:`` group (``conf/<group>/<name>.yaml`` -> ``cfg[group]``),
  applies *experiment* files at global scope (every ``conf/experiment/*.yaml``
  is global by convention), then applies ``a.b.c=value`` overrides, then
  resolves ``${dotted.path}`` / ``${env:VAR}`` interpolations;
- group selection can be overridden like hydra's: ``experiment=esrgan_pre_training``,
  ``generator=rcan``.

The files and the override values are read with
:mod:`climsr_tpu_torch.config.yaml_subset`, never PyYAML, so the GPU machine
(which may lack PyYAML) and a workstation run one code path. Reference parity
anchor: ``conf/config.yaml`` + ``climsr/cli/train.py:147-166``.
"""
from __future__ import annotations

import copy
import os
import re
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence, Union

from climsr_tpu_torch.config.yaml_subset import ConfigError, load_yaml

__all__ = ["ConfigError", "compose", "default_config_dir"]

_INTERP_RE = re.compile(r"\$\{([^}]+)\}")

GLOBAL_PACKAGE_GROUPS = {"experiment", "plugins"}


def _load_yaml(path: Path) -> Dict[str, Any]:
    if not path.exists():
        raise ConfigError(f"Config file not found: {path}")
    data = load_yaml(path.read_text(), str(path))
    return data or {}


def _deep_merge(base: Dict[str, Any], override: Dict[str, Any]) -> Dict[str, Any]:
    out = dict(base)
    for k, v in override.items():
        if k in out and isinstance(out[k], dict) and isinstance(v, dict):
            out[k] = _deep_merge(out[k], v)
        else:
            out[k] = copy.deepcopy(v)
    return out


def _set_dotted(cfg: Dict[str, Any], key: str, value: Any) -> None:
    parts = key.split(".")
    node = cfg
    for p in parts[:-1]:
        node = node.setdefault(p, {})
        if not isinstance(node, dict):
            raise ConfigError(f"Cannot set '{key}': '{p}' is not a mapping")
    node[parts[-1]] = value


def _get_dotted(cfg: Dict[str, Any], key: str) -> Any:
    node: Any = cfg
    for p in key.split("."):
        if not isinstance(node, dict) or p not in node:
            raise KeyError(key)
        node = node[p]
    return node


def _resolve_interpolations(cfg: Dict[str, Any], max_passes: int = 10) -> Dict[str, Any]:
    def resolve_value(v: Any) -> Any:
        if not isinstance(v, str):
            return v
        full = _INTERP_RE.fullmatch(v.strip())
        if full:
            return lookup(full.group(1), v)
        return _INTERP_RE.sub(lambda m: str(lookup(m.group(1), v)), v)

    def lookup(expr: str, original: str) -> Any:
        if expr.startswith("env:") or expr.startswith("oc.env:"):
            var = expr.split(":", 1)[1]
            if var not in os.environ:
                raise ConfigError(f"Environment variable '{var}' required by '{original}' is not set")
            return os.environ[var]
        try:
            return _get_dotted(cfg, expr)
        except KeyError:
            raise ConfigError(f"Interpolation '{original}' references unknown key '{expr}'")

    def walk(node: Any) -> Any:
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v) for v in node]
        return resolve_value(node)

    for _ in range(max_passes):
        new = walk(cfg)
        if new == cfg:
            return new
        cfg = new
    raise ConfigError("Interpolation did not converge (circular reference?)")


def _parse_override(item: str) -> tuple[str, Any]:
    if "=" not in item:
        raise ConfigError(f"Override '{item}' must look like key=value")
    key, raw = item.split("=", 1)
    value = load_yaml(raw, f"override {item!r}") if raw != "" else None
    return key.strip(), value


def _load_group_file(config_dir: Path, group: str, name: str) -> Dict[str, Any]:
    """Load conf/<group>/<name>.yaml, following its own local ``defaults`` list."""
    path = config_dir / group / f"{name}.yaml"
    data = _load_yaml(path)
    local_defaults = data.pop("defaults", None)
    base: Dict[str, Any] = {}
    if local_defaults:
        for entry in local_defaults:
            if entry in (None, "_self_"):
                continue
            if isinstance(entry, str):
                base = _deep_merge(base, _load_group_file(config_dir, group, entry))
            elif isinstance(entry, dict):
                for sub_name in entry.values():
                    if sub_name is not None:
                        base = _deep_merge(base, _load_group_file(config_dir, group, sub_name))
    return _deep_merge(base, data)


def compose(
    config_dir: Union[str, Path],
    config_name: str = "config",
    overrides: Optional[Sequence[str]] = None,
) -> Dict[str, Any]:
    """Compose the full config dict from the config tree + CLI-style overrides."""
    config_dir = Path(config_dir)
    root = _load_yaml(config_dir / f"{config_name}.yaml")
    defaults: List[Any] = root.pop("defaults", [])
    overrides = list(overrides or [])

    # Split overrides into group selections (match a defaults-list group) and
    # value overrides (dotted keys).
    group_names = []
    for entry in defaults:
        if isinstance(entry, dict):
            group_names.extend(entry.keys())
    selections: Dict[str, Optional[str]] = {}
    value_overrides: List[tuple[str, Any]] = []
    for item in overrides:
        key, value = _parse_override(item)
        # `group=name` selects a group file; `group={...}` / `group=null` with a
        # structured value is a value override merged after composition.
        if key in group_names and "." not in key and isinstance(value, str):
            selections[key] = value
        elif key in group_names and "." not in key and value is None:
            selections[key] = None
        else:
            value_overrides.append((key, value))

    # Preload global layers (experiment presets) so a mandatory group ('???')
    # satisfied by the experiment body doesn't demand a CLI selection — the
    # reference handles this with hydra's `override /generator: ...` lines.
    preloaded_globals: List[Dict[str, Any]] = []
    for entry in defaults:
        if isinstance(entry, dict):
            for group, name in entry.items():
                if group in GLOBAL_PACKAGE_GROUPS:
                    name = selections.get(group, name)
                    if name not in (None, "???"):
                        preloaded_globals.append(_load_group_file(config_dir, group, name))
    globally_provided = {k for layer in preloaded_globals for k in layer}

    # hydra '_self_-first' semantics: the root body is the BASE layer and the
    # defaults-list groups merge over it (conf/config.yaml lists _self_ first)
    cfg: Dict[str, Any] = copy.deepcopy(root)
    global_layers: List[Dict[str, Any]] = []
    # group -> the `name:` VALUE of the CLI-selected group file (file stems
    # and name values are different namespaces: discriminator=
    # rfb_esrgan_discriminator selects a file whose name value is rfb_esrgan)
    selected_name_values: Dict[str, Any] = {}
    for entry in defaults:
        if entry in (None, "_self_"):
            continue
        if not isinstance(entry, dict):
            raise ConfigError(f"Unsupported defaults entry: {entry!r}")
        for group, name in entry.items():
            name = selections.get(group, name)
            if name is None:
                if group in selections:
                    selected_name_values[group] = None
                cfg.setdefault(group, None)
                continue
            if name == "???":
                if group in selections:
                    name = selections[group]
                elif group in globally_provided:
                    # The experiment body names the selection (e.g. generator:
                    # {name: esrgan}); load that group file as the base so
                    # group defaults (nb, gc, ...) still apply underneath.
                    provided = next(
                        (layer[group] for layer in preloaded_globals if isinstance(layer.get(group), dict)), None
                    )
                    sel = (provided or {}).get("name")
                    if sel and (config_dir / group / f"{sel}.yaml").exists():
                        name = sel
                    else:
                        continue
                else:
                    raise ConfigError(f"Config group '{group}' is mandatory — pass {group}=<name>")
            if isinstance(name, list):
                merged: Dict[str, Any] = {}
                for n in name:
                    merged = _deep_merge(merged, {n: _load_group_file(config_dir, group, n)})
                cfg[group] = merged
                continue
            data = _load_group_file(config_dir, group, name)
            if group in selections:
                selected_name_values[group] = data.get("name", name) if isinstance(data, dict) else name
            if group in GLOBAL_PACKAGE_GROUPS:
                global_layers.append(data)
                cfg.setdefault(group, name)
            else:
                cfg[group] = _deep_merge(cfg.get(group) or {}, data)

    for layer in global_layers:
        # An explicit CLI group selection outranks the experiment body's
        # *selection* for that group (hydra semantics — the reference's
        # experiments carry `override /generator: ...` defaults-list entries):
        # `experiment=... generator=rcan` must yield a clean rcan config, not
        # the experiment's esrgan body merged over it. Selection-style bodies
        # are the dicts carrying a 'name'; value-style bodies (trainer
        # tweaks etc.) keep hydra's value-merge behavior.
        if selections:
            # ...but re-selecting the SAME name the experiment already picked
            # is a no-op, not an opt-out: the experiment's value tweaks for
            # that group (e.g. discriminator.in_channels) must survive.
            layer = {
                k: v
                for k, v in layer.items()
                if not (
                    k in selections
                    and isinstance(v, dict)
                    and "name" in v
                    and selected_name_values.get(k, selections[k]) != v.get("name")
                )
            }
        cfg = _deep_merge(cfg, layer)
    for key, value in value_overrides:
        _set_dotted(cfg, key, value)
    return _resolve_interpolations(cfg)


def default_config_dir() -> Path:
    """The repo-root ``conf/`` tree shipped with the framework."""
    return Path(__file__).resolve().parents[2] / "conf"
