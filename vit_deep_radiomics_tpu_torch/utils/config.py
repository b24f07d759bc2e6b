"""Config tree: the merged ``conf/parameters*.y(a)ml`` files.

Counterpart of ``vit_deep_radiomics_tpu/utils/config.py``: the project
root is the nearest ancestor holding ``.git``, and the configuration is
the deep merge of every ``conf/parameters*.yml|yaml`` there in sorted-name
order, so generated files (the k-fold YAML of ``data/splits.py``) join it
on the next load. ``yaml`` is imported inside the functions that read or
write it.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Any, Mapping

__all__ = ["get_project_dir", "load_all_ymls", "load_conf", "deep_merge",
           "save_yaml"]


def get_project_dir(start: str | os.PathLike | None = None) -> Path:
    """Nearest ancestor of *start* (default: the working directory) that
    contains ``.git``."""
    here = Path(start or os.getcwd()).resolve()
    for candidate in (here, *here.parents):
        if (candidate / ".git").exists():
            return candidate
    raise FileNotFoundError(
        f"no project root (directory containing .git) above {here}")


def deep_merge(base: dict, update: Mapping) -> dict:
    """Recursively merge *update* into a copy of *base* (update wins)."""
    out = dict(base)
    for key, val in update.items():
        if key in out and isinstance(out[key], dict) \
                and isinstance(val, Mapping):
            out[key] = deep_merge(out[key], val)
        else:
            out[key] = val
    return out


def load_all_ymls(config_folder: str | os.PathLike,
                  startswith: str = "parameters") -> dict[str, Any]:
    """Merge every ``{startswith}*.yml|yaml`` of *config_folder*, in
    sorted-name order."""
    import yaml

    folder = Path(config_folder)
    config: dict[str, Any] = {}
    if not folder.is_dir():
        return config
    for path in sorted(folder.iterdir()):
        if path.name.startswith(startswith) and \
                path.suffix in (".yml", ".yaml"):
            with open(path) as fh:
                data = yaml.safe_load(fh)
            if data:
                config = deep_merge(config, data)
    return config


def load_conf(startswith: str = "parameters",
              root: str | os.PathLike | None = None) -> dict[str, Any]:
    """The merged config tree of ``<project>/conf``."""
    return load_all_ymls(get_project_dir(root) / "conf", startswith)


def save_yaml(data: Mapping, path: str | os.PathLike) -> None:
    """Write a YAML file (the generated k-fold map)."""
    import yaml

    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "w") as fh:
        yaml.dump(dict(data), fh)
