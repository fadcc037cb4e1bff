"""The manifest (BENCHMARK.json) and the files it names: each configuration,
traffic mix, limit set and metric is a file of its own under this folder,
found by its name."""

from __future__ import annotations

import importlib.util
import json
import re
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
CHECKOUT = HERE.parent
# top-level module names that no process of the benchmark may hold
FORBIDDEN = ("jax", "jaxlib", "flax", "aligator_tpu")


def manifest() -> dict:
    return json.loads((CHECKOUT / "BENCHMARK.json").read_text())


def path_of(kind: str, name: str, ext: str) -> Path:
    return HERE / kind / f"{name}{ext}"


def load(kind: str, name: str):
    """The module ``portbench/<kind>/<name>.py`` (a name may hold dots)."""
    mod_name = f"portbench.{kind}.{re.sub(r'[^A-Za-z0-9_]', '_', name)}"
    if mod_name in sys.modules:
        return sys.modules[mod_name]
    spec = importlib.util.spec_from_file_location(mod_name, path_of(kind, name, ".py"))
    if spec is None:
        raise FileNotFoundError(path_of(kind, name, ".py"))
    mod = importlib.util.module_from_spec(spec)
    sys.modules[mod_name] = mod
    spec.loader.exec_module(mod)
    return mod


def data(kind: str, name: str) -> dict:
    return json.loads(path_of(kind, name, ".json").read_text())


def cell(man: dict, name: str) -> dict:
    for w in man["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def metrics_of(man: dict, section: str, cell_name: str) -> list:
    """The entries of ``section`` ("end_to_end" or "per_layer") that this
    cell reports: those without a ``workloads`` key and those that list it."""
    return [m for m in man[section] if cell_name in m.get("workloads", [cell_name])]


def forbidden_loaded() -> list:
    """Top-level names of loaded modules that the benchmark forbids,
    compared whole (``aligator_tpu_torch`` is not ``aligator_tpu``)."""
    return sorted({k.split(".")[0] for k in list(sys.modules)} & set(FORBIDDEN))
