"""Tiny cells for the CPU tests: the benchmark's configurations and
mixes with the sizes cut, the drivers and the reference unchanged.

Each cell's cut is a file of its own, ``portbench/tiny/<cell>.json``:

- ``config``: overrides in the configuration file's own keys, so each
  family is cut by its own names;
- ``traffic``: overrides of the traffic mix (nested groups merged key by
  key);
- ``tight`` (optional): the limits its float32 run holds to the
  reference (``test_portbench_reference``);
- ``workload`` (optional, for a cell measured but left out of
  ``BENCHMARK.json``): its entry as ``workloads`` would hold it, with
  ``like`` naming the cell whose metrics it reports.
"""
from __future__ import annotations

import copy
import os

from portbench import harness

DIR = os.path.join(harness.HERE, "tiny")


def sizes(name: str) -> dict:
    """The tiny file of cell ``name``."""
    path = os.path.join(DIR, name + ".json")
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"no tiny sizes for cell {name!r}: add "
            f"{os.path.relpath(path, harness.ROOT)} with its config, "
            "traffic and tight overrides")
    return harness.load_json(path)


def names() -> list:
    """Every cell of ``BENCHMARK.json`` in its order, then the cells that
    only a tiny file names (measured but left out of it)."""
    bench = [w["name"] for w in harness.load_json(
        harness.ROOT, "BENCHMARK.json")["workloads"]]
    files = sorted(f[:-len(".json")] for f in os.listdir(DIR)
                   if f.endswith(".json"))
    return bench + [n for n in files if n not in bench]


def tight_names() -> list:
    """The cells whose tiny file holds float32 limits."""
    return [n for n in names()
            if os.path.exists(os.path.join(DIR, n + ".json"))
            and "tight" in sizes(n)]


def merged(base: dict, over: dict) -> dict:
    out = copy.deepcopy(base)
    for k, v in over.items():
        if isinstance(v, dict) and isinstance(out.get(k), dict):
            out[k] = merged(out[k], v)
        else:
            out[k] = copy.deepcopy(v)
    return out


def cell(name: str) -> harness.Cell:
    cut = sizes(name)
    bench = harness.load_json(harness.ROOT, "BENCHMARK.json")
    if "workload" in cut:
        w = cut["workload"]
        bench["workloads"].append(dict(w, name=name))
        for m in bench["end_to_end"] + bench["per_layer"]:
            if w.get("like") in m.get("workloads", ()):
                m["workloads"].append(name)
    c = harness.Cell(name, bench)
    c.config = merged(c.config, cut["config"])
    c.traffic = merged(c.traffic, cut["traffic"])
    return c
