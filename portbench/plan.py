"""What a cell is made of, found by name: its entry in ``BENCHMARK.json``,
its configuration file, its traffic mix (``traffic/<name>.json``), its
limits (``workloads/<cell>.json``), the builder of its configuration's
model (``programs/<model>.py``), the plain reference its mix names
(``reference/<reference>.py``, by default ``reference/<sampling>.py``)
and the readers of its per-layer metrics (``metrics/<name>.py``).
Nothing here is specific to a cell: a new cell, configuration, mix,
model, reference or metric is a new file."""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import re
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


@dataclasses.dataclass
class Plan:
    cell: str
    config_name: str
    config: dict
    traffic_name: str
    traffic: dict
    chips: int
    limits: dict
    end_to_end: list
    per_layer: list


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


def resolve(cell: str, bench: dict, root: Path = ROOT,
            traffic_dir: Path | None = None,
            workload_dir: Path | None = None) -> Plan:
    """The plan of ``cell``: every file it names, loaded."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if cell not in cells:
        raise SystemExit(f"unknown workload {cell!r}; BENCHMARK.json has "
                         f"{sorted(cells)}")
    entry = cells[cell]
    configs = {c["name"]: c for c in bench["configs"]}
    conf = configs[entry["config"]]
    config = load_json(root / conf["file"])
    traffic = load_json((traffic_dir or HERE / "traffic")
                        / f"{entry['traffic']}.json")
    limits = load_json((workload_dir or HERE / "workloads")
                       / f"{cell}.json")["limits"]

    def applies(metric):
        return cell in metric.get("workloads", [cell])

    return Plan(cell, conf["name"], config, entry["traffic"], traffic,
                int(entry["chips"]), limits,
                [m for m in bench["end_to_end"] if applies(m)],
                [m for m in bench["per_layer"] if applies(m)])


class MissingPart(LookupError):
    """A cell names a part the benchmark has no file for yet."""


def part(kind: str, folder: str, name: str):
    """The module ``portbench/<folder>/<name>.py``, loaded once; a
    :class:`MissingPart` naming the file to add where there is none."""
    path = HERE / folder / f"{name}.py"
    if not path.is_file():
        raise MissingPart(f"portbench has no {kind} {name!r}: add "
                          f"portbench/{folder}/{name}.py")
    module_name = "portbench.%s.%s" % (folder, re.sub(r"\W", "_", name))
    if module_name not in sys.modules:
        spec = importlib.util.spec_from_file_location(module_name, path)
        module = importlib.util.module_from_spec(spec)
        sys.modules[module_name] = module
        try:
            spec.loader.exec_module(module)
        except BaseException:
            del sys.modules[module_name]
            raise
    return sys.modules[module_name]


def metric_reader(name: str):
    """The ``read(readings)`` function of ``metrics/<name>.py``.  A split
    metric, ``<name>.<cells>``, is ``<name>`` read the same way in some
    cells under a name of its own (one that moves another end-to-end
    metric), and has the same reader."""
    return part("per-layer metric", "metrics", name.split(".")[0]).read


def program(model: str):
    """The ``build(config, traffic, device)`` function of
    ``programs/<model>.py``: the program's problem for a configuration."""
    return part("program builder for the model", "programs", model).build


def reference_of(traffic: dict):
    """The plain reference of a traffic mix: ``reference/<name>.py``,
    where ``name`` is the mix's optional ``reference`` key, else its
    ``sampling`` (the estimator's own reference).  It has
    ``campaign(config, traffic)`` and ``Reference(campaign, observed,
    device, tf32=False)``."""
    return part("reference", "reference",
                traffic.get("reference", traffic["sampling"]))
