"""The curriculum-distillation quality proof through the port's CLIs, as
a test (the port's counterpart of tests/test_distill.py).

Runs ``tools/distill_experiment_torch.py`` on the CPU: warm-up,
iteration-0 evaluation, candidate mining, oracle-teacher curriculum
buckets, then three distillation iterations against a same-budget
binary-label control, every step through the port's CLIs (the
per-iteration evaluation on length-bucketed on-device index builds). It
asserts the two verdicts of tests/test_distill.py:

  - improves_over_iterations: every curriculum iteration beats the
    pre-distillation baseline on nDCG@10, final recall beats iteration 0,
    and the arm does not decay within the curriculum;
  - beats_control: the distilled student beats the control on both
    nDCG@10 and recall.

Excluded from the default suite by the ``distill`` marker (the root
conftest.py also marks it slow); run with::

    python -m pytest tests/test_torch_distill.py -m distill -q
"""
import json
import os
import sys

import pytest

TOOLS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tools")


def _import_experiment():
    sys.path.insert(0, TOOLS)
    try:
        import distill_experiment_torch
    finally:
        sys.path.remove(TOOLS)
    return distill_experiment_torch


@pytest.mark.distill
@pytest.mark.parametrize("fast_path", [False, True],
                         ids=["einsum_flat", "kernels_packed"])
def test_curriculum_distillation_improves_retrieval(tmp_path, fast_path):
    """``kernels_packed``: the attention kernels' route (their plain
    versions on the CPU, the counter-hash dropout included) with packed
    passages, the configuration the card trains with."""
    report = _import_experiment().run(
        str(tmp_path), device="cpu",
        attention_impl="pallas" if fast_path else "xla",
        pack_passages=fast_path)
    print(json.dumps(report))
    assert report["checks"]["improves_over_iterations"], report
    assert report["checks"]["beats_control"], report
