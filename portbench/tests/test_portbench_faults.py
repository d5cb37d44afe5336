"""``correct`` comes out false when the timed path is broken underneath
(the rest of a run driven as usual, on the CPU at a tiny size, under the
cells' own limits), and when the control, the reference at fp8 in the
port's place, is judged as the port is.

Faults, each where the cell can have it: a step that returns its state
unchanged; half of the batch left out and the mean taken over the rest;
an answer altered where it is produced.
"""
import importlib

import numpy as np
import pytest
import torch

from portbench import harness
from portbench.tests import tiny

RETRIEVE = "distilbert.retrieve.exact-int8-b512"
TRAIN = "distilbert.train.flat-bz8"
TEACHER = "minilm.teacher.flat-top100"
TRAIN_DP = "distilbert.train.dp4-bz8"
# the cells of BENCHMARK.json, and with them those only a tiny file names
BENCH_CELLS = [w["name"] for w in harness.load_json(
    harness.ROOT, "BENCHMARK.json")["workloads"]]


def _run(name):
    return harness.run_cell(tiny.cell(name), 11, 0.2, False, device="cpu")


def test_train_state_unchanged(monkeypatch):
    from cldrd_tpu_torch.train import optim

    monkeypatch.setattr(optim.Optimizer, "step", lambda self, grads: True)
    res = _run(TRAIN)
    assert not res["correct"]
    assert res["checks"]["change_err"]["value"] >= 0.99


def test_train_half_batch(monkeypatch):
    from cldrd_tpu_torch import losses

    real = losses.lambda_mrr_loss

    def half(y_pred, y_true, *a, **k):
        n = y_pred.shape[0] // 2
        return real(y_pred[:n], y_true[:n], *a, **k)

    monkeypatch.setattr(losses, "lambda_mrr_loss", half)
    res = _run(TRAIN)
    assert not res["correct"]
    assert res["checks"]["change_err"]["value"] > \
        res["checks"]["change_err"]["limit"]


def drop_exchange():
    """In a rank: the gradients' all-reduce left out (the host group's
    integer agreements still go through)."""
    import torch.distributed as dist

    real = dist.all_reduce

    def local(tensor, *args, **kwargs):
        if tensor.is_floating_point() and "group" not in kwargs:
            return None
        return real(tensor, *args, **kwargs)

    dist.all_reduce = local


def test_train_dp_exchange_left_out(monkeypatch):
    from portbench.drivers import train

    monkeypatch.setenv(train.RANK_SETUP,
                       "portbench.tests.test_portbench_faults:drop_exchange")
    res = _run(TRAIN_DP)
    assert not res["correct"]


def test_train_dp_sound():
    """The same data-parallel run with the exchange in place: four gloo
    ranks on the CPU, held to the reference with each rank's masks."""
    res = _run(TRAIN_DP)
    assert res["correct"], res["checks"]


def test_retrieve_answer_altered(monkeypatch):
    from cldrd_tpu_torch.index.flat_index import FlatIPIndex

    real = FlatIPIndex.search_batched

    def altered(self, queries, k, **kw):
        s, i = real(self, queries, k, **kw)
        i = i.copy()
        row = len(i) // 3
        i[row, k // 2] = (i[row, k // 2] + 7919) % self.embeddings.shape[0]
        return s, i

    monkeypatch.setattr(FlatIPIndex, "search_batched", altered)
    assert not _run(RETRIEVE)["correct"]


def test_retrieve_score_altered(monkeypatch):
    from cldrd_tpu_torch.index.flat_index import FlatIPIndex

    real = FlatIPIndex.search_batched

    def altered(self, queries, k, **kw):
        s, i = real(self, queries, k, **kw)
        s = s.copy()
        s[len(s) // 2, 0] *= 1.5
        return s, i

    monkeypatch.setattr(FlatIPIndex, "search_batched", altered)
    assert not _run(RETRIEVE)["correct"]


def test_teacher_score_altered(monkeypatch):
    from cldrd_tpu_torch.evaluation import reranking_evaluator as ev

    real = ev.make_cross_encoder_score_fn

    def make(model):
        fn = real(model)

        def altered(batch):
            out = np.array(fn(batch))
            out[batch.n_valid // 2] += 0.5 * np.abs(out).mean()
            return out

        return altered

    monkeypatch.setattr(ev, "make_cross_encoder_score_fn", make)
    assert not _run(TEACHER)["correct"]


def test_teacher_half_batch(monkeypatch):
    from cldrd_tpu_torch.data import reranking_dataset as rd

    real = rd.RerankingDataset.batches

    def half(self, batch_size):
        for b in real(self, batch_size):
            b.n_valid = b.n_valid // 2
            yield b

    monkeypatch.setattr(rd.RerankingDataset, "batches", half)
    assert not _run(TEACHER)["correct"]


@pytest.mark.parametrize("name", tiny.names())
def test_control_parts_from_the_port(name):
    """At the test's size the control, judged as the port is, reads at
    least three times what the port's sound run reads on one of the
    cell's numbers (the cells' limits are set at their own sizes: see
    ``test_control_fails_at_cell_size``)."""
    cell = tiny.cell(name)
    drv = importlib.import_module("portbench.drivers."
                                  + cell.traffic["driver"])
    sound = harness.run_cell(cell, 23, 0.2, False, device="cpu")["checks"]
    control = drv.control(harness.Run(cell, 23, 0.2, False, "cpu"))
    assert any(v >= 3 * sound[k]["value"] for k, v in control.items()
               if sound[k]["value"] > 0), (control, sound)


@pytest.mark.cuda
@pytest.mark.parametrize("name", BENCH_CELLS)
def test_control_fails_at_cell_size(name):
    """On the card: the control at the cell's own size, on three seeds,
    fails the cell's limits on each (``python -m pytest --noconftest
    portbench/tests -m cuda``)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the control runs at the cell's "
                    "own size")
    cell = harness.Cell(name)
    drv = importlib.import_module("portbench.drivers."
                                  + cell.traffic["driver"])
    for seed in (3500000011, 3500000023, 3500000041):
        numbers = drv.control(harness.Run(cell, seed, 1.0, False, "cuda"))
        assert any(v > cell.limits[k] for k, v in numbers.items()), numbers


@pytest.mark.parametrize("name", BENCH_CELLS)
def test_sound_tiny_runs_pass_their_limits(name):
    """The tiny cells' sound runs are correct under the cells' limits."""
    res = _run(name)
    assert res["correct"], res["checks"]
