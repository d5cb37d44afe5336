"""The plain reference against the port's plain paths on the CPU, at a
tiny size: with the configuration's compute type set to float32 the
port's window (its CPU plain versions of the kernels, the dropout masks
of its training steps, its batch order, tokenizer, loss and AdamW) and
the reference agree to float32's rounding; in bf16 they part by
bf16's."""
import importlib

import pytest
import torch

from portbench import harness
from portbench.reference import dropout as ref_dropout
from portbench.tests import tiny

# the cells whose tiny file (``portbench/tiny/<cell>.json``) holds
# ``tight``: float32 on both sides, so differences are float32 rounding
# (the search still scores bf16 queries: the port's int8 stores take
# bf16 queries)
CELLS = tiny.tight_names()


@pytest.mark.parametrize("name", CELLS)
def test_float32_port_equals_reference(name):
    cell = tiny.cell(name)
    cell.config["compute_dtype"] = "float32"
    tight = tiny.sizes(name)["tight"]
    cell.limits = {k: tight[k] for k in cell.limits}
    res = harness.run_cell(cell, 2**31 + 17, 0.2, False, device="cpu")
    assert res["correct"], res["checks"]


@pytest.mark.parametrize("name", CELLS)
def test_bf16_port_parts_from_reference_by_rounding(name):
    cell = tiny.cell(name)
    cell.limits = {k: 0.0 if k == "bad_lists" else 0.1
                   for k in cell.limits}
    res = harness.run_cell(cell, 5, 0.2, False, device="cpu")
    assert res["correct"], res["checks"]
    values = [c["value"] for k, c in res["checks"].items()
              if k != "bad_lists"]
    assert max(values) > 1e-4  # bf16 rounding shows


def test_dropout_masks_are_the_ports():
    """The reference's masks of a step equal the port's DropoutRNG's, for
    the drawn and the hashed kind."""
    from cldrd_tpu_torch.models.distilbert import DropoutRNG
    from cldrd_tpu_torch.ops.attention import dropout_keep_mask

    port = DropoutRNG(12345, 3, "cpu")
    ref = ref_dropout.StepDropout(12345, 3, "cpu", 0.1, 0.1)
    x = torch.ones(4, 5, 6)
    assert torch.equal(port.dropout(x, 0.1), ref.hidden(x))
    probs = torch.ones(2, 3, 7, 7)
    seed = port.next_seed()
    want = torch.where(dropout_keep_mask(2, 3, 7, 7, seed, 0.1),
                       probs / 0.9, torch.zeros_like(probs))
    assert torch.equal(ref.probs_hashed(probs), want)


def test_drivers_have_a_control():
    for name in CELLS:
        drv = importlib.import_module(
            "portbench.drivers." + tiny.cell(name).traffic["driver"])
        assert callable(drv.control)
