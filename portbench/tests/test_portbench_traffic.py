"""A CPU rehearsal of every traffic mix through the port at a tiny size:
the work counted (in the unit its driver declares), and the result's
shape, untraced and traced. The run command itself refuses to run
without a card."""
import importlib
import json
import os

import pytest

from portbench import harness, run as run_cmd
from portbench.tests import tiny

BENCH = harness.load_json(harness.ROOT, "BENCHMARK.json")
CELLS = tiny.names()


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("trace", [False, True], ids=["untraced", "traced"])
def test_rehearsal(name, trace):
    cell = tiny.cell(name)
    res = harness.run_cell(cell, 3, 0.3, trace, device="cpu")
    assert list(res)[:3] == ["correct", "attempted", "failed"]
    assert list(res)[-1] == "checks"
    drv = importlib.import_module("portbench.drivers."
                                  + cell.traffic["driver"])
    per = drv.units(cell.traffic)
    assert res["attempted"] > 0 and res["attempted"] % per == 0, \
        f"{res['attempted']} {drv.UNIT} attempted, not whole units of {per}"
    assert res["failed"] == 0
    if trace:
        assert "breakdown" in res and "busy_s" in res["device"]
        names = {m["name"] for m in cell.per_layer}
        # the window's rate is read on the CPU too; device times are not
        mfu = [n for n in names if "mfu" in n]
        assert mfu and set(mfu) <= set(res["metrics"])
    else:
        names = {m["name"] for m in cell.end_to_end}
        assert set(res["metrics"]) == names
        # a device's busy time reads 0 on the CPU, where nothing runs on one
        for m in cell.end_to_end:
            value = res["metrics"][m["name"]]["value"]
            assert value > 0 if m["source"] == "host_clock" else value >= 0
    json.dumps(res)


def test_every_name_has_its_files():
    here = os.path.join(harness.ROOT, "portbench")
    left_out = [dict(tiny.sizes(n)["workload"], name=n) for n in CELLS
                if n not in {w["name"] for w in BENCH["workloads"]}]
    for w in BENCH["workloads"] + left_out:
        assert os.path.exists(os.path.join(here, "traffic",
                                           w["traffic"] + ".json"))
        assert os.path.exists(os.path.join(here, "limits",
                                           w["name"] + ".json"))
        assert os.path.exists(os.path.join(here, "tiny",
                                           w["name"] + ".json"))
    for c in BENCH["configs"]:
        assert os.path.exists(os.path.join(harness.ROOT, c["file"]))
    for m in BENCH["per_layer"]:
        assert os.path.exists(harness.reader_path(m["name"]))


def test_refuses_without_a_card(monkeypatch, capsys):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = run_cmd.main(["--workload", CELLS[0], "--seed", "1",
                       "--seconds", "1", "--trace", "0"])
    assert rc != 0
    assert capsys.readouterr().out == ""
