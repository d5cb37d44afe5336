"""Curriculum training: ``cli.train``'s path, ``Trainer.train`` over an
``NwayDataset``.

Set-up: the collection, the queries and the n-way training file
(``relT_most_semi_hard`` JSONL: ``n_relT`` teacher positives,
``n_most_hard`` and ``n_semi_hard`` negatives a query) written from the
seed into ``TMPDIR`` and loaded by ``NwayDataset.create_from_files``;
a ``Trainer`` with the mix's ``train`` settings, handed the seed's
weights. One ``Trainer.train`` call runs everything: the harness marks
the steps through the query tower's entry, which every step calls
first, and through ``step_hook``, which receives each step's metrics
when the trainer fetches them (every ``logging_steps``).

- Steps 1..``followed_steps``: the steps the reference follows. Before
  step 2 the first clipped gradient's norm by leaf is read from AdamW's
  first moment (``exp_avg / (1 - beta1)``); before step
  ``followed_steps + 1`` each leaf's change from the initial weights.
- Steps up to ``warmup_steps_run``: warm-up. The window opens at the
  next step's start and closes at the first step start after
  ``--seconds`` at which the followed steps' losses have arrived;
  ``train_examples_s`` is the examples of the steps in between over
  the window's seconds (data waits, the periodic metric fetch and log
  line, the optimizer all inside it).
- The late step, the first after the window (the same call and feed,
  after as many steps): its parameters and AdamW moments are copied to
  the host at its start, its logits kept, and each leaf's change read at
  the next step's start.
- Then ``trace_steps`` more steps are traced, in every run: their
  device-busy time a step is ``train_step_device_ms``, and with
  ``--trace 1`` the per-layer readers read the same trace. Then the
  harness ends the call by raising ``WindowClosed`` from the hook.

The comparison: each followed step's logits and the change after the
followed steps leaf by leaf (the losses and the first gradient's norms
logged beside them), against the reference's float32 steps over the
same batches (the training order, tokens and labels worked out again
from the seed) with the same dropout masks, each rank's own under data
parallelism; and the late step's logits and change by leaf against the
reference's step from the port's own state at the late step's start
(parameters, moments and update count, rank 0's), over that step's
batch and masks worked out again. Leaves whose reference gradient is
under a thousandth of the median leaf's (a key's bias under softmax)
are left out of the leaf numbers.
"""
from __future__ import annotations

import json
import os
import pickle
import shutil
import time
from typing import Dict

import numpy as np
import torch
import torch.distributed as dist

from portbench import harness, inputs, roofline
from portbench.harness import log
from portbench.reference import dropout as ref_dropout
from portbench.reference import encoder as ref_encoder
from portbench.reference import train as ref_train
from portbench.reference.text import batch_order, hash_tokenize, nway_labels

from . import dims, free_device, port_config

UNIT = "examples"


def units(traffic: dict) -> int:
    """The examples of one step (every rank's)."""
    return traffic["train"]["batch_size"]


class WindowClosed(Exception):
    """Raised from the step hook to end ``Trainer.train`` after the
    window."""


def make_data(seed: int, t: dict):
    """(query texts, passage texts, examples) of the mix."""
    q = inputs.texts(seed, 1, t["examples"], t["query_words"],
                     t["vocab_words"], t["zipf"])
    p = inputs.texts(seed, 2, t["passages"], t["passage_words"],
                     t["vocab_words"], t["zipf"])
    g = inputs.rng(seed, "examples")
    n_rel, n_most, n_semi = t["n_relT"], t["n_most_hard"], t["n_semi_hard"]
    nway = n_rel + n_most + n_semi
    examples = []
    for qid in range(t["examples"]):
        pids = g.choice(t["passages"], size=nway, replace=False).tolist()
        scores = np.sort(g.normal(size=nway))[::-1].round(4).tolist()
        examples.append({
            "qid": qid,
            "relT_pids": pids[:n_rel], "relT_scores": scores[:n_rel],
            "most_hard_pids": pids[n_rel:n_rel + n_most],
            "most_hard_scores": scores[n_rel:n_rel + n_most],
            "semi_hard_pids": pids[n_rel + n_most:],
            "semi_hard_scores": scores[n_rel + n_most:]})
    return q, p, examples


def train_seed(seed: int) -> int:
    return inputs.sub_seed(seed, "train")


def write_data(seed: int, t: dict, data) -> dict:
    """The mix's files in a fresh directory: {q, p, e, dir} paths."""
    qtexts, ptexts, examples = data
    work = inputs.work_dir()
    paths = {k: os.path.join(work, f) for k, f in (
        ("q", "queries.tsv"), ("p", "collection.tsv"),
        ("e", "train.jsonl"))}
    inputs.write_tsv(paths["q"], range(len(qtexts)), qtexts)
    inputs.write_tsv(paths["p"], range(len(ptexts)), ptexts)
    with open(paths["e"], "w", encoding="utf-8") as f:
        for ex in examples:
            f.write(json.dumps(ex) + "\n")
    paths["dir"] = work
    return paths


def run(run):
    t = run.traffic
    world = int(t.get("ranks", 1))
    data = make_data(run.seed, t)
    paths = write_data(run.seed, t, data)
    try:
        if world == 1:
            ranks = [train_process(run, paths, 0, 1)]
        else:
            ranks = spawn_ranks(run, paths, world)
    finally:
        shutil.rmtree(paths["dir"], ignore_errors=True)
    first = ranks[0]
    if world > 1:
        # the parent's age when rank 0 opened the window
        run.setup_s = first["opened_at"] - (time.time()
                                            - harness.process_age())
        log(f"setup_s {run.setup_s:.3f} (ranks: "
            f"{[round(r['setup_s'], 3) for r in ranks]})")
        run.memory_peak = max(r["memory_peak"] for r in ranks)
        run.trace_data = first["trace"]
        if run.trace_data is not None:
            run.trace_data.busy_s = float(np.mean(
                [r["trace"].busy_s for r in ranks]))
        run.launch_check = [f"rank {i}: {line}" for i, r in enumerate(ranks)
                            for line in r["launch_check"]]
        run.spans = first["spans"]
    tr = t["train"]
    d = dims(run.config)
    bz = tr["batch_size"]
    steps = first["window_steps"]
    shapes = {"batch_size": bz // world, "nway": t["n_relT"]
              + t["n_most_hard"] + t["n_semi_hard"],
              "lq": tr["max_query_len"], "lp": tr["max_passage_len"],
              "trace_steps": t["trace_steps"],
              "traced_units": t["trace_steps"], "dim": d["dim"],
              "model_units": t["trace_steps"], "model_span": None,
              "n_layers": d["n_layers"], "n_heads": d["n_heads"]}
    window = {"units": steps, "chips": world, "examples": steps * bz,
              "seconds": first["elapsed"],
              "flops": window_flops(t, d, *data, first["open_step"], steps,
                                    train_seed(run.seed))}
    late = first.pop("late_state")
    # the traced steps' device-busy seconds, averaged over the ranks
    device_s = float(np.mean([r["trace"].all_busy_s() for r in ranks]))

    def check():
        ref = reference(run, *data)
        if late:  # else the late numbers are missing, and fail
            ref.update(reference_late(run, data, late))
        per_rank = [numbers(r["program"], ref) for r in ranks]
        return {k: max(n[k] for n in per_rank) for k in per_rank[0]}

    return {"attempted": steps * bz, "failed": 0,
            "metrics": {"train_examples_s": steps * bz / first["elapsed"],
                        "train_step_device_ms": 1e3 * device_s
                        / t["trace_steps"]},
            "window": window, "shapes": shapes, "check": check,
            "late_state": late}


def train_process(run, paths: dict, rank: int, world: int) -> dict:
    """One process's (one rank's) ``Trainer.train`` call: the followed
    steps' readings, the warm-up, the window and any traced steps."""
    from cldrd_tpu_torch.data import HashTokenizer, NwayDataset
    from cldrd_tpu_torch.ops import attention, residual_norm
    from cldrd_tpu_torch.parallel.multihost import host_group
    from cldrd_tpu_torch.train import TrainConfig, Trainer

    t, dev = run.traffic, torch.device(run.device)
    d = dims(run.config)
    tr = t["train"]
    cfg = TrainConfig(
        queries_path=paths["q"], passages_path=paths["p"],
        training_path=paths["e"], seed=train_seed(run.seed),
        run_folder=os.path.join(paths["dir"], "runs"),
        experiment_name="portbench",
        compute_dtype=run.config["compute_dtype"], **tr)
    dataset = NwayDataset.create_from_files(
        paths["q"], paths["p"], paths["e"],
        HashTokenizer(vocab_size=d["vocab_size"]), tr["max_query_len"],
        tr["max_passage_len"], tr["label_mode"], fmt="relT_most_semi_hard",
        pack_passages=tr["pack_passages"])
    with torch.device(dev):
        trainer = Trainer(cfg, port_config(run.config), device=dev)
    weights = inputs.make_weights(ref_encoder.dual_encoder_specs(d),
                                  run.seed, dev, d["weights_std"])
    group = host_group() if world > 1 else None

    followed, warm = t["followed_steps"], t["warmup_steps_run"]
    state = {"step": 0, "t0": None, "open_step": None, "trace_step": None,
             "trace_cm": None, "elapsed": None, "window_steps": None,
             "opened_at": None, "marks": []}
    seen: Dict[str, object] = {}
    losses: Dict[int, float] = {}
    logits: Dict[int, torch.Tensor] = {}
    model = trainer.model
    entry, logit_entry = model.query_embs, model.logits

    def grad_norms():
        adamw = trainer.optimizer.adamw
        names = {id(p): n for n, p in model.named_parameters()}
        out = {}
        for group_ in adamw.param_groups:
            beta1 = group_["betas"][0]
            for p in group_["params"]:
                st = adamw.state.get(p, {})
                if "exp_avg" in st:  # none where no update was taken
                    out[names[id(p)]] = torch.linalg.vector_norm(
                        st["exp_avg"]) / (1 - beta1)
        return _floats(out) if out else {}

    def change_norms(start):
        return _floats({n: torch.linalg.vector_norm(
            p.detach().to(start[n].device) - start[n])
            for n, p in model.named_parameters()})

    def late_state(k):
        """The state the late step (step ``k``) starts from, on the host:
        parameters, AdamW's moments and the updates taken."""
        adamw = trainer.optimizer.adamw
        params = dict(model.named_parameters())
        names = {id(p): n for n, p in params.items()}
        host = {n: p.detach().to("cpu", copy=True) for n, p in params.items()}
        m = {n: torch.zeros_like(x) for n, x in host.items()}
        v = {n: torch.zeros_like(x) for n, x in host.items()}
        updates = set()
        for group_ in adamw.param_groups:
            for p in group_["params"]:
                st = adamw.state.get(p, {})
                if "exp_avg" in st:
                    m[names[id(p)]].copy_(st["exp_avg"])
                    v[names[id(p)]].copy_(st["exp_avg_sq"])
                    updates.add(int(st["step"]))
        if len(updates) != 1:  # the reference then departs from the port
            log(f"AdamW's update counts at step {k}: {sorted(updates)}")
        return {"step": k, "updates": max(updates, default=k - 1),
                "params": host, "m": m, "v": v}

    def counters():
        return {"attn_fwd": attention.LAUNCHES["train_fwd"],
                "attn_bwd": attention.LAUNCHES["train_bwd"],
                "residual_norm_fwd": residual_norm.LAUNCHES["fwd"],
                "residual_norm_bwd": residual_norm.LAUNCHES["bwd"]}

    def window_over() -> bool:
        """Rank 0's clock decides, and every rank hears it."""
        ready = all(s in losses for s in range(1, followed + 1))
        over = ready and time.perf_counter() - state["t0"] >= run.seconds
        if group is None:
            return over
        flag = torch.tensor([int(over)])
        dist.broadcast(flag, src=0, group=group)
        return bool(flag.item())

    def hooked(queries, rng=None):
        state["step"] += 1
        k = state["step"]
        if k == 2:
            seen["grad"] = grad_norms()
        if k == followed + 1:
            seen["change"] = change_norms(weights)
            seen["logits"] = [logits[s].cpu() for s in sorted(logits)
                              if s <= followed]
        if k == warm + 1:
            run.window_opens()
            state["t0"], state["open_step"] = time.perf_counter(), k
            state["marks"].append((k, state["t0"]))
        elif state["open_step"] is not None and state["elapsed"] is None:
            if (k - state["open_step"]) % MARK_STEPS == 0:
                state["marks"].append((k, time.perf_counter()))
            if window_over():
                run.sync()
                state["elapsed"] = time.perf_counter() - state["t0"]
                run.close_spans()
                state["window_steps"] = k - state["open_step"]
                _log_marks(state["marks"], tr["batch_size"])
                seen["late"] = late_state(k)
        elif "late" in seen and k == seen["late"]["step"] + 1:
            seen["late_change"] = change_norms(seen["late"]["params"])
            state["trace_cm"] = run.traced(counters)
            state["trace_cm"].__enter__()
            state["trace_step"] = k
        elif state["trace_step"] is not None and \
                k == state["trace_step"] + t["trace_steps"]:
            state["trace_cm"].__exit__(None, None, None)
            raise WindowClosed
        return entry(queries, rng)

    def logits_hooked(q, p):
        out = logit_entry(q, p)
        k = state["step"]
        if k <= followed or ("late" in seen and k == seen["late"]["step"]):
            logits[k] = out.detach().float().clone()
        return out

    def step_hook(step, metrics):
        if step <= followed:
            losses[step] = float(metrics["loss"])

    model.query_embs, model.logits = hooked, logits_hooked
    try:
        trainer.train(dataset, init_params=weights, step_hook=step_hook)
        raise RuntimeError("the training data ran out before the window "
                           "closed: raise the mix's examples")
    except WindowClosed:
        pass
    finally:
        del model.query_embs, model.logits
    run.window_closed()
    late = seen.get("late", {})
    del trainer, model, entry, logit_entry, weights, dataset
    free_device()
    return {"window_steps": state["window_steps"],
            "open_step": state["open_step"], "elapsed": state["elapsed"],
            "setup_s": run.setup_s, "opened_at": run.opened_at,
            "memory_peak": run.memory_peak, "trace": run.trace_data,
            "launch_check": run.launch_check,
            "spans": run.spans,
            "program": {"losses": [losses.get(s)
                                   for s in range(1, followed + 1)],
                        "logits": seen.get("logits", []),
                        "grad_norms": seen.get("grad", {}),
                        "change_norms": seen.get("change", {}),
                        "late_logits": [logits[late["step"]].cpu()]
                        if late.get("step") in logits else [],
                        "late_change_norms": seen.get("late_change", {})},
            # the late step's start, for the reference: rank 0's alone
            "late_state": late if rank == 0 else None}


# the window's steps are marked every MARK_STEPS for the log's chunk rates
MARK_STEPS = 25


def _log_marks(marks, batch_size: int) -> None:
    """The window's examples a second chunk by chunk (a log line, not a
    metric: the metric is the whole window's rate)."""
    rates = [round((k1 - k0) * batch_size / (t1 - t0), 3)
             for (k0, t0), (k1, t1) in zip(marks, marks[1:])]
    log(f"window chunks of {MARK_STEPS} steps, examples/s: {rates}")


RANK_SETUP = "PORTBENCH_RANK_SETUP"


def _rank_main(rank: int, world: int, port: int, run, paths: dict,
               out_dir: str) -> None:
    """One spawned rank: its device, the group, the training call; its
    result pickled to ``out_dir``. ``PORTBENCH_RANK_SETUP`` may name a
    ``module:function`` each rank calls first (the tests' faults)."""
    import importlib

    setup = os.environ.get(RANK_SETUP)
    if setup:
        mod, fn = setup.split(":")
        getattr(importlib.import_module(mod), fn)()
    torch.set_num_threads(1)
    cuda = run.device != "cpu"
    if cuda:
        torch.cuda.set_device(rank)
    dist.init_process_group("nccl" if cuda else "gloo",
                            init_method=f"tcp://127.0.0.1:{port}",
                            world_size=world, rank=rank)
    try:
        res = train_process(run, paths, rank, world)
        with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(res, f)
    finally:
        dist.destroy_process_group()


def spawn_ranks(run, paths: dict, world: int) -> list:
    """``world`` spawned processes, one a device, each running
    ``train_process``; returns their results in rank order once all have
    ended."""
    import socket

    import torch.multiprocessing as mp

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    out_dir = os.path.join(paths["dir"], "ranks")
    os.makedirs(out_dir)
    mp.start_processes(_rank_main,
                       args=(world, port, run, paths, out_dir),
                       nprocs=world, start_method="spawn")
    out = []
    for r in range(world):
        with open(os.path.join(out_dir, f"rank{r}.pkl"), "rb") as f:
            out.append(pickle.load(f))
    return out


def window_flops(t, d, qtexts, ptexts, examples, open_step, steps,
                 seed) -> float:
    """The model's FLOPs (forward and backward, 3x the forward, at the
    texts' real token counts) of the window's steps, ``open_step`` the
    first (counted from 1)."""
    tr = t["train"]
    q_len, p_len = [], []
    for idx in step_rows(len(examples), tr["batch_size"], seed,
                         range(open_step - 1, open_step - 1 + steps)):
        for i in idx:
            e = examples[i]
            q_len.append(min(len(qtexts[e["qid"]].split()) + 2,
                             tr["max_query_len"]))
            p_len += [min(len(ptexts[p].split()) + 2, tr["max_passage_len"])
                      for p in e["relT_pids"] + e["most_hard_pids"]
                      + e["semi_hard_pids"]]
    return 3.0 * (roofline.seq_fwd_flops(q_len, d["dim"], d["hidden_dim"],
                                         d["n_layers"])
                  + roofline.seq_fwd_flops(p_len, d["dim"], d["hidden_dim"],
                                           d["n_layers"]))


def step_rows(n_examples: int, batch_size: int, seed: int, steps):
    """The examples of each step of ``steps`` (counted from 0), epoch by
    epoch in the training order."""
    per_epoch = n_examples // batch_size
    orders = {}
    for s in steps:
        epoch = s // per_epoch
        if epoch not in orders:
            orders[epoch] = batch_order(n_examples, batch_size, seed, epoch)
        yield orders[epoch][s % per_epoch]


def _floats(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    names = list(tensors)
    values = torch.stack([tensors[n].float() for n in names]).cpu().tolist()
    return dict(zip(names, values))


def reference_batches(run, qtexts, ptexts, examples, steps):
    """The batches of ``steps`` (counted from 0), tokens and labels
    worked out again."""
    t, dev = run.traffic, torch.device(run.device)
    tr = t["train"]
    vocab = dims(run.config)["vocab_size"]
    labels = nway_labels(t["n_relT"], t["n_most_hard"], t["n_semi_hard"])
    out = []
    for idx in step_rows(len(examples), tr["batch_size"],
                         train_seed(run.seed), steps):
        exs = [examples[i] for i in idx]
        q = hash_tokenize([qtexts[e["qid"]] for e in exs],
                          tr["max_query_len"], vocab)
        pids = [pid for e in exs for pid in e["relT_pids"]
                + e["most_hard_pids"] + e["semi_hard_pids"]]
        p = hash_tokenize([ptexts[pid] for pid in pids],
                          tr["max_passage_len"], vocab)
        bz = len(exs)
        out.append({
            "q_ids": torch.from_numpy(q["input_ids"]).to(dev),
            "q_mask": torch.from_numpy(q["attention_mask"]).to(dev),
            "p_ids": torch.from_numpy(p["input_ids"]).to(dev).view(
                bz, len(labels), -1),
            "p_mask": torch.from_numpy(p["attention_mask"]).to(dev).view(
                bz, len(labels), -1),
            "labels": torch.from_numpy(np.tile(labels, (bz, 1))).to(dev)})
    return out


def reference(run, qtexts, ptexts, examples, quant=None,
              rows=slice(None), own=None) -> dict:
    """The reference's followed steps. ``quant``: the control; ``rows``:
    the examples of each batch that take part (all but in a fault);
    ``own``: the one rank whose rows carry gradients (a fault)."""
    t, dev = run.traffic, torch.device(run.device)
    d = dims(run.config)
    n, world = t["followed_steps"], int(t.get("ranks", 1))
    batches = [{k: v[rows] for k, v in b.items()} for b in
               reference_batches(run, qtexts, ptexts, examples, range(n))]
    drops = [[ref_dropout.StepDropout(
        train_seed(run.seed), s, dev, d["dropout"], d["attention_dropout"],
        stream=r if world > 1 else None) for r in range(world)]
        for s in range(n)]
    p0 = inputs.make_weights(ref_encoder.dual_encoder_specs(d), run.seed,
                             dev, d["weights_std"])
    out = ref_train.follow(p0, d, t["train"], batches, drops, quant, own)
    del p0, batches
    free_device()
    return out


def reference_late(run, data, late: dict, quant=None, rows=slice(None),
                   own=None) -> dict:
    """The reference's late step from the port's state at its start
    (``late``: parameters, AdamW moments, updates taken), over that
    step's batch and masks; ``quant``, ``rows``, ``own`` as in
    ``reference``."""
    t, dev = run.traffic, torch.device(run.device)
    d = dims(run.config)
    world = int(t.get("ranks", 1))
    s = late["step"] - 1
    batch = {k: v[rows] for k, v in
             reference_batches(run, *data, [s])[0].items()}
    drops = [[ref_dropout.StepDropout(
        train_seed(run.seed), s, dev, d["dropout"], d["attention_dropout"],
        stream=r if world > 1 else None) for r in range(world)]]

    def on(x):
        return {n: a.to(dev) for n, a in x.items()}

    out = ref_train.follow(on(late["params"]), d, t["train"], [batch], drops,
                           quant, own, start=late["updates"],
                           moments=(on(late["m"]), on(late["v"])))
    free_device()
    return {"late_logits": out["logits"],
            "late_grad_norms": out["grad_norms"],
            "late_change_norms": out["change_norms"]}


def _keep(grad_norms: Dict[str, float]):
    """The leaves whose reference gradient is a thousandth of the median
    leaf's or more."""
    med = float(np.median(list(grad_norms.values())))
    return [n for n, v in grad_norms.items() if v >= 1e-3 * med]


def _leaf_gap(got: Dict[str, float], want: Dict[str, float],
              keep) -> float:
    """The worst leaf's gap of norms, over the larger of the leaf's and
    the median leaf's reference norm."""
    if not got:
        return float("inf")
    med = float(np.median([want[n] for n in keep]))
    gaps = {n: abs(got.get(n, 0.0) - want[n]) / max(want[n], med, 1e-30)
            for n in keep}
    worst = max(gaps, key=gaps.get)
    log(f"worst leaf {worst}: {got.get(worst)} against {want[worst]} "
        f"(median leaf {med:.6g}); median gap "
        f"{float(np.median(list(gaps.values()))):.6g}")
    return gaps[worst]


def _logit_gap(got, want) -> float:
    """The widest gap of a followed step's logits, over the spread of the
    reference's logits of that example (the rows both have)."""
    if len(got) != len(want):
        return float("inf")
    worst = 0.0
    for a, b in zip(got, want):
        a, b = torch.as_tensor(a).float(), torch.as_tensor(b).float()
        n = min(len(a), len(b))
        spread = b[:n].std(dim=1, keepdim=True).clamp(min=1e-30)
        worst = max(worst, float(((a[:n] - b[:n]).abs() / spread).max()))
    return worst


def numbers(program: dict, ref: dict) -> dict:
    """The numbers compared: the followed steps' logits and the change's
    norm by leaf; where the reference followed the late step, its logits
    and change too. Logged beside them, not compared (PERF.md gives the
    readings): the losses, since lambda_mrr weighs each pair by the
    ranks the logits sort it to and a swap of two near-tied logits moves
    a step's loss by a few percent; and the first gradient's norm by
    leaf, which no control or fault reads three times above its sound
    runs."""
    g_ref = ref["grad_norms"]
    keep = _keep(g_ref)
    log(f"losses {program['losses']} against {ref['losses']}")
    log(f"grad_err {_leaf_gap(program['grad_norms'], g_ref, keep)!r} "
        "(not compared)")
    out = {"logit_err": _logit_gap(program["logits"], ref["logits"]),
           "change_err": _leaf_gap(program["change_norms"],
                                   ref["change_norms"], keep)}
    if "late_change_norms" in ref:
        out["late_logit_err"] = _logit_gap(program.get("late_logits", []),
                                           ref["late_logits"])
        out["late_change_err"] = _leaf_gap(
            program.get("late_change_norms", {}), ref["late_change_norms"],
            _keep(ref["late_grad_norms"]))
    return out


# calibrate.py hands the control and the faults a run of the port: the
# late step is followed from the port's state
CONTROL_NEEDS_RUN = True


def _judged(run, out, **fault) -> dict:
    """The reference with ``fault`` in the port's place, judged against
    the float32 reference; with ``out`` (a run of the port) the late step
    too, from the port's state."""
    data = make_data(run.seed, run.traffic)
    got, want = reference(run, *data, **fault), reference(run, *data)
    if out is not None:
        got.update(reference_late(run, data, out["late_state"], **fault))
        want.update(reference_late(run, data, out["late_state"]))
    return numbers(got, want)


def control(run, out=None) -> dict:
    """The reference in the port's place at fp8 (e4m3) products."""
    return _judged(run, out, quant=ref_encoder.fp8_e4m3)


def fault_half_batch(run, out=None) -> dict:
    """The reference in the port's place with half of each batch left
    out and the mean taken over the rest."""
    return _judged(run, out,
                   rows=slice(0, run.traffic["train"]["batch_size"] // 2))


def fault_no_exchange(run, out=None) -> dict:
    """Data parallel only: the reference in rank 0's place with the
    gradients not exchanged (its own rows' gradient alone)."""
    if int(run.traffic.get("ranks", 1)) == 1:
        raise NotImplementedError("one rank: nothing is exchanged")
    return _judged(run, out, own=0)
