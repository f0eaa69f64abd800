"""Config system: YAML files + CLI dotlist overrides with dot-access nodes
(the port's copy of starvector_tpu/config.py).

Rebuilds the reference's OmegaConf usage (reference: starvector/util.py:279-292,
starvector/validation/validate.py:42-48) without the omegaconf dependency:
  cfg = load_yaml(default) ⊕ load_yaml(experiment) ⊕ parse_dotlist(argv)
Merge is deep (dict-wise), right-biased. Values in dotlists are YAML-parsed so
`training.lr=3e-4`, `model.freeze=[a,b]`, `flag=true` all coerce naturally.

Also provides `instantiate_from_config` (reference: starvector/util.py:148-158):
a `{target: "pkg.mod.Class", params: {...}}` block instantiates the named class.
The repo's configs name the JAX package's datasets
(`starvector_tpu.data.datasets.*`); the port reads them as they are and
instantiates the counterpart under `starvector_tpu_torch.data`.
"""

from __future__ import annotations

import copy
import importlib
import os
from typing import Any, Iterable, Mapping

import yaml


class ConfigNode(dict):
    """A dict with attribute access and deep merge, like a DictConfig."""

    def __getattr__(self, key: str) -> Any:
        try:
            return self[key]
        except KeyError as e:
            raise AttributeError(key) from e

    def __setattr__(self, key: str, value: Any) -> None:
        self[key] = _wrap(value)

    def __delattr__(self, key: str) -> None:
        try:
            del self[key]
        except KeyError as e:
            raise AttributeError(key) from e

    def __setitem__(self, key: str, value: Any) -> None:
        super().__setitem__(key, _wrap(value))

    # -- helpers ---------------------------------------------------------
    def get_path(self, dotted: str, default: Any = None) -> Any:
        node: Any = self
        for part in dotted.split("."):
            if isinstance(node, Mapping) and part in node:
                node = node[part]
            else:
                return default
        return node

    def set_path(self, dotted: str, value: Any) -> None:
        parts = dotted.split(".")
        node = self
        for part in parts[:-1]:
            nxt = node.get(part)
            if not isinstance(nxt, ConfigNode):
                nxt = ConfigNode()
                node[part] = nxt
            node = nxt
        node[parts[-1]] = value

    def to_dict(self) -> dict:
        return _unwrap(self)

    def to_yaml(self) -> str:
        return yaml.safe_dump(self.to_dict(), sort_keys=False)

    def copy(self) -> "ConfigNode":  # type: ignore[override]
        return _wrap(copy.deepcopy(_unwrap(self)))


def _wrap(value: Any) -> Any:
    if isinstance(value, ConfigNode):
        return value
    if isinstance(value, Mapping):
        node = ConfigNode()
        for k, v in value.items():
            node[k] = v
        return node
    if isinstance(value, list):
        return [_wrap(v) for v in value]
    return value


def _unwrap(value: Any) -> Any:
    if isinstance(value, Mapping):
        return {k: _unwrap(v) for k, v in value.items()}
    if isinstance(value, list):
        return [_unwrap(v) for v in value]
    return value


def merge(*configs: Mapping | None) -> ConfigNode:
    """Deep right-biased merge; dicts merge recursively, others replace."""
    out = ConfigNode()
    for cfg in configs:
        if cfg is None:
            continue
        _merge_into(out, cfg)
    return out


def _merge_into(dst: ConfigNode, src: Mapping) -> None:
    for k, v in src.items():
        if isinstance(v, Mapping) and isinstance(dst.get(k), ConfigNode):
            _merge_into(dst[k], v)
        else:
            dst[k] = v


def load_yaml(path: str | os.PathLike) -> ConfigNode:
    with open(path) as f:
        data = yaml.safe_load(f) or {}
    if not isinstance(data, Mapping):
        raise ValueError(f"top-level YAML in {path} must be a mapping")
    return _wrap(data)


def parse_dotlist(args: Iterable[str]) -> ConfigNode:
    """Parse `a.b.c=value` CLI overrides; values are YAML-coerced."""
    node = ConfigNode()
    for arg in args:
        if "=" not in arg:
            raise ValueError(f"dotlist override must be key=value, got {arg!r}")
        key, raw = arg.split("=", 1)
        try:
            value = yaml.safe_load(raw) if raw != "" else None
        except yaml.YAMLError:
            value = raw
        quoted = raw[:1] in ("'", '"')
        if isinstance(value, str) and not quoted:
            # YAML 1.1 misses floats like "3e-4" (no dot); coerce them —
            # but an explicitly quoted value (run.tag='"001"') stays a
            # string: the user quoted it precisely to defeat coercion
            try:
                value = float(value)
                if value == int(value) and ("e" not in raw.lower()
                                            and "." not in raw):
                    value = int(value)
            except ValueError:
                pass
        node.set_path(key.strip(), value)
    return node


def get_config(
    argv: list[str] | None = None,
    *,
    default_path: str | None = None,
    config_key: str = "config",
) -> ConfigNode:
    """Reference-parity entry (starvector/util.py:279-292): merge an optional
    default yaml, a `config=<path>` yaml named on the CLI, and all remaining
    dotlist overrides — in that order."""
    import sys

    argv = list(sys.argv[1:] if argv is None else argv)
    cfg_path = None
    rest = []
    for a in argv:
        if a.startswith(config_key + "="):
            cfg_path = a.split("=", 1)[1]
        else:
            rest.append(a)
    layers: list[Mapping | None] = []
    if default_path:
        if not os.path.exists(default_path):
            # A missing default layer silently dropping the optimizer
            # recipe / freeze flags / data blocks is worse than a crash
            # (the reference crashes loudly too, starvector/util.py:280).
            raise FileNotFoundError(
                f"default config layer not found: {default_path!r} "
                f"(cwd={os.getcwd()!r}). Pass an absolute path — entry "
                "points should anchor it via "
                "starvector_tpu_torch.config.resolve_repo_config().")
        layers.append(load_yaml(default_path))
    if cfg_path:
        layers.append(load_yaml(cfg_path))
    layers.append(parse_dotlist(rest))
    cfg = merge(*layers)
    if cfg_path:
        cfg["config"] = cfg_path
    return cfg


def resolve_repo_config(rel_path: str = "configs/models/default.yaml") -> str:
    """Resolve a configs/ path independent of CWD (reference anchors all
    paths at the repo root and crashes when the yaml is absent,
    starvector/util.py:280; `get_config` previously dropped the whole
    default layer silently when launched from any other directory).

    Search order: $STARVECTOR_CONFIG_ROOT, the repo root derived from the
    installed package location, then the CWD. Raises with every tried path
    when the file exists in none of them."""
    roots = []
    env_root = os.environ.get("STARVECTOR_CONFIG_ROOT")
    if env_root:
        roots.append(env_root)
    pkg_root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    roots.extend([pkg_root, os.getcwd()])
    tried = []
    for root in roots:
        cand = os.path.join(root, rel_path)
        tried.append(cand)
        if os.path.exists(cand):
            return cand
    raise FileNotFoundError(
        f"could not resolve {rel_path!r}; tried: {tried}. Set "
        "STARVECTOR_CONFIG_ROOT to the directory containing configs/.")


def instantiate_from_config(block: Mapping, **extra_kwargs: Any) -> Any:
    """Instantiate `block['target']` with `block['params']` (reference:
    starvector/util.py:148-158)."""
    if "target" not in block:
        raise KeyError("expected `target` key in instantiation block")
    cls = get_obj_from_str(block["target"])
    params = dict(_unwrap(block.get("params", {}) or {}))
    params.update(extra_kwargs)
    return cls(**params)


JAX_PACKAGE = "starvector_tpu."
PORT_PACKAGE = "starvector_tpu_torch."


def port_target(path: str) -> str:
    """A config target as the port imports it: `starvector_tpu.data.X` is
    the port's `starvector_tpu_torch.data.X`; any other target of the JAX
    package has no counterpart here and raises."""
    if path.startswith(JAX_PACKAGE + "data."):
        return PORT_PACKAGE + path[len(JAX_PACKAGE):]
    if path.startswith(JAX_PACKAGE):
        raise ValueError(f"config target {path!r} names the JAX package, and the port has no "
                         "counterpart for it (only starvector_tpu.data.* targets map to "
                         "starvector_tpu_torch.data.*)")
    return path


def get_obj_from_str(path: str) -> Any:
    module_name, _, obj_name = port_target(path).rpartition(".")
    module = importlib.import_module(module_name)
    return getattr(module, obj_name)
