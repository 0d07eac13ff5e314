"""Hydra-0.11-style YAML configs (counterpart of ``tggcn/config.py``).

The train and predict entry points read the repo's ``conf/`` files: a root
``config.yaml`` whose ``defaults`` list names one file of each group
(``models``, ``data``), merged under the root; ``${a.b.c}`` interpolation
(inside strings too) and ``${env:VAR}``; attribute access (``cfg.data.name``)
and OmegaConf 1.4's ``.get(key, default_value=...)``; command-line
overrides ``key.sub=value`` and group choices ``models=2G-GCN_stage1``; and
the resolved config frozen to ``<run_dir>/.hydra/config.yaml``, which the
predict entry point reads back.
"""

import os
import re
from typing import Any, List, Optional

import yaml

_INTERP_RE = re.compile(r"\$\{([^${}]+)\}")


class _YamlLoader(yaml.SafeLoader):
    """SafeLoader with YAML-1.2 float semantics ('1e-4' parses as a float).

    The reference configs write learning rates as '1e-4'
    (conf/models/2G-GCN_stage1.yaml:34), which OmegaConf parses as a float but
    YAML 1.1 treats as a string.
    """


_YamlLoader.add_implicit_resolver(
    "tag:yaml.org,2002:float",
    re.compile(
        r"""^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+]?[0-9]+)?
        |[-+]?(?:[0-9][0-9_]*)(?:[eE][-+]?[0-9]+)
        |\.[0-9_]+(?:[eE][-+][0-9]+)?
        |[-+]?\.(?:inf|Inf|INF)
        |\.(?:nan|NaN|NAN))$""",
        re.X,
    ),
    list("-+0123456789."),
)


class Config(dict):
    """A dict with attribute access and OmegaConf-1.4-style ``get``."""

    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __setattr__(self, name: str, value: Any) -> None:
        self[name] = value

    def get(self, key: str, default_value: Any = None, default: Any = None):  # noqa: D102
        if key in self:
            return self[key]
        return default_value if default_value is not None else default

    def to_dict(self) -> dict:
        return _to_plain(self)


def _to_config(obj: Any) -> Any:
    if isinstance(obj, dict):
        return Config({k: _to_config(v) for k, v in obj.items()})
    if isinstance(obj, list):
        return [_to_config(v) for v in obj]
    return obj


def _to_plain(obj: Any) -> Any:
    if isinstance(obj, dict):
        return {k: _to_plain(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_to_plain(v) for v in obj]
    return obj


def _deep_merge(base: dict, override: dict) -> dict:
    out = dict(base)
    for k, v in override.items():
        if k in out and isinstance(out[k], dict) and isinstance(v, dict):
            out[k] = _deep_merge(out[k], v)
        else:
            out[k] = v
    return out


def _lookup(root: dict, dotted: str) -> Any:
    node: Any = root
    for part in dotted.split("."):
        node = node[part]
    return node


def _coerce_scalar(value: str) -> Any:
    """Parse a string override value using YAML scalar rules."""
    try:
        return yaml.load(value, Loader=_YamlLoader)
    except yaml.YAMLError:
        return value


def _resolve_value(value: Any, root: dict, _depth: int = 0) -> Any:
    if _depth > 16:
        raise ValueError("Config interpolation too deep (cycle?)")
    if isinstance(value, str):
        full_match = _INTERP_RE.fullmatch(value.strip())
        if full_match:
            resolved = _resolve_ref(full_match.group(1), root, _depth)
            return resolved

        def sub(match: "re.Match[str]") -> str:
            resolved = _resolve_ref(match.group(1), root, _depth)
            return str(resolved)

        prev = None
        while prev != value and _INTERP_RE.search(value):
            prev = value
            value = _INTERP_RE.sub(sub, value)
        return value
    return value


def _resolve_ref(ref: str, root: dict, depth: int) -> Any:
    ref = ref.strip()
    if ref.startswith("env:"):
        return os.environ.get(ref[len("env:"):], "")
    try:
        target = _lookup(root, ref)
    except (KeyError, TypeError):
        # Unresolvable reference: keep the literal placeholder (lenient, like
        # OmegaConf's lazy resolution for keys never accessed).
        return "${" + ref + "}"
    return _resolve_value(target, root, depth + 1)


def _resolve_tree(node: Any, root: dict) -> Any:
    if isinstance(node, dict):
        return {k: _resolve_tree(v, root) for k, v in node.items()}
    if isinstance(node, list):
        return [_resolve_tree(v, root) for v in node]
    return _resolve_value(node, root)


def load_yaml(path: str) -> dict:
    with open(path, mode="r") as f:
        return yaml.load(f, Loader=_YamlLoader) or {}


def compose(config_dir: str, config_name: str = "config.yaml",
            overrides: Optional[List[str]] = None, resolve: bool = True) -> Config:
    """Compose a config from a root file + defaults groups + CLI overrides."""
    overrides = list(overrides or [])
    root_cfg = load_yaml(os.path.join(config_dir, config_name))
    defaults = root_cfg.pop("defaults", [])

    # Group overrides of the form 'group=option' replace the defaults entry.
    group_choices = {}
    for entry in defaults:
        if isinstance(entry, dict):
            group_choices.update(entry)
    value_overrides = []
    for ov in overrides:
        key, _, val = ov.partition("=")
        if key in group_choices and "." not in key:
            group_choices[key] = val
        else:
            value_overrides.append((key, val))

    merged: dict = {}
    for group, option in group_choices.items():
        option_file = os.path.join(config_dir, group, f"{option}.yaml")
        merged = _deep_merge(merged, load_yaml(option_file))
    merged = _deep_merge(merged, root_cfg)

    for key, val in value_overrides:
        node = merged
        parts = key.split(".")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = _coerce_scalar(val)

    if resolve:
        merged = _resolve_tree(merged, merged)
    return _to_config(merged)


def load_config(path: str, resolve: bool = True) -> Config:
    """Load a single (already composed) YAML config file, e.g. a frozen run config."""
    cfg = load_yaml(path)
    if resolve:
        cfg = _resolve_tree(cfg, cfg)
    return _to_config(cfg)


def save_config(cfg: Config, path: str) -> None:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, mode="w") as f:
        yaml.safe_dump(_to_plain(cfg), f, default_flow_style=False, sort_keys=False)
