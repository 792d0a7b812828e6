"""A cell's parts, found by the names ``BENCHMARK.json`` gives them.

configs/<config>.json      the deployment (sizes, channels, precision, draw)
traffic/<traffic>.json     the entry, its unit of work and the check's sample
entries/<entry>.py         the code that drives the program for that entry
checks/<kind>.py           the comparison the traffic's ``check`` names by
                           ``kind`` (``synth21cm`` where it names none): what
                           it samples, records and keeps, its numbers and
                           its control's
limits/<workload>.json     the limit of each number the check compares
metrics/<metric>.py        the reader of each per-layer metric (+ its data)
"""

from __future__ import annotations

import importlib.util
import json
import os

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)
DEFAULT_CHECK = "synth21cm"


def _json(*parts):
    with open(os.path.join(BENCH_DIR, *parts)) as f:
        return json.load(f)


def load_module(kind, name):
    """The module ``benchmark/<kind>/<name>.py``."""
    path = os.path.join(BENCH_DIR, kind, name + ".py")
    spec = importlib.util.spec_from_file_location(f"bench_{kind}_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _applies(metric, workload):
    return "workloads" not in metric or workload in metric["workloads"]


class Cell:
    """One workload of ``BENCHMARK.json`` with everything it names."""

    def __init__(self, workload, bench=None):
        if bench is None:
            with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
                bench = json.load(f)
        cells = {w["name"]: w for w in bench["workloads"]}
        if workload not in cells:
            raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
        self.name = workload
        self.workload = cells[workload]
        self.chips = int(self.workload["chips"])
        self.config = _json("configs", self.workload["config"] + ".json")
        self.traffic = _json("traffic", self.workload["traffic"] + ".json")
        self.limits = _json("limits", workload + ".json")
        self.end_to_end = [m for m in bench["end_to_end"] if _applies(m, workload)]
        reported = {m["name"] for m in self.end_to_end}
        self.per_layer = [m for m in bench["per_layer"]
                          if _applies(m, workload) and m["moves"] in reported]
        self.run_seconds = int(bench["run_seconds"])

    def entry(self):
        return load_module("entries", self.traffic["entry"])

    def check(self):
        return load_module("checks", self.traffic["check"].get("kind", DEFAULT_CHECK))

    def reader(self, metric):
        return load_module("metrics", metric["name"])
