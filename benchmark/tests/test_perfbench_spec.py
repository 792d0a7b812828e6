"""Every part BENCHMARK.json names is found by its name, and the file keeps
to the names and units the benchmark's contract allows."""

import json
import os
import re

import pytest
from conftest import BENCH, bench_json

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_names_and_units():
    b = bench_json()
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [x["name"] for x in b[group]]
        assert len(names) == len(set(names))
        assert all(NAME.match(n) for n in names)
    for m in b["end_to_end"] + b["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    e2e = {m["name"] for m in b["end_to_end"]}
    assert e2e == {"maps_per_s", "chunk_p95_ms", "peak_mem_gib", "setup_s"}
    assert all(m["moves"] in e2e for m in b["per_layer"])


@pytest.mark.parametrize("w", [w["name"] for w in bench_json()["workloads"]])
def test_cell_parts_found_by_name(w):
    from harness import spec

    cell = spec.Cell(w, bench_json())
    assert os.path.exists(os.path.join(BENCH, "entries", cell.traffic["entry"] + ".py"))
    assert {"cl", "maps"} <= set(cell.limits) and all(v > 0 for v in cell.limits.values())
    chk = cell.check()
    assert all(callable(getattr(chk, f))
               for f in ("sample", "count", "record", "keep", "compare", "control"))
    assert cell.per_layer and cell.end_to_end
    for m in cell.per_layer:
        assert callable(cell.reader(m).read)
    entry = cell.entry()
    assert all(callable(getattr(entry, f)) for f in ("setup", "unit", "keep_roots", "release"))


def test_config_files_match_their_entries():
    b = bench_json()
    for c in b["configs"]:
        with open(os.path.join(os.path.dirname(BENCH), c["file"])) as f:
            cfg = json.load(f)
        assert cfg["name"] == c["name"]
        assert cfg["source"] == c["source"] and len(c["source"]) <= 200
        assert cfg["reduced"] == c["reduced"]
        assert cfg["lmax"] == 3 * cfg["nside"] - 1
