"""Rank processes for the data-parallel tests
(``tests/test_torch_multi.py``). It imports no JAX, so the spawned
processes start in seconds: ``run_group`` starts ``world`` processes that
join one gloo group on localhost; each runs the given training jobs in
turn with the port's ``Trainer`` on the CPU and writes what it saw to
``<out_dir>/<job>.rank<r>.pt``. ``run_curriculum`` launches
``cli.curriculum`` on ``world`` ranks as ``torchrun`` would."""
import datetime
import functools
import json
import os
import signal
import socket
import time

import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def tiny_dataset(cls, tok_cls, n=16):
    """The Trainer parity tests' dataset: one relevant and five filler
    passages per query."""
    queries = {q: f"query about topic {q}" for q in range(n)}
    passages, examples, pid = {}, [], 0
    for q in range(n):
        rel = pid
        passages[pid] = f"passage exactly answering topic {q} " + "x " * (q % 5)
        pid += 1
        negs = []
        for j in range(5):
            passages[pid] = f"unrelated filler text {pid} banana {j}"
            negs.append(pid)
            pid += 1
        examples.append({"qid": q, "relT_pids": [rel], "neg_pids": negs})
    return cls(queries, passages, examples, tok_cls(vocab_size=512),
               max_query_len=12, max_passage_len=16, label_mode="1")


def _train_rank(rank, world, port, jobs, init_path, out_dir):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=world)
    try:
        from cldrd_tpu_torch.data import HashTokenizer, NwayDataset
        from cldrd_tpu_torch.models import DistilBertConfig
        from cldrd_tpu_torch.train import TrainConfig, Trainer
        from cldrd_tpu_torch.train import trainer as trainer_mod

        saves = []
        real_save = trainer_mod.save_checkpoint

        def counted_save(*args, **kwargs):
            saves.append(args[2])
            return real_save(*args, **kwargs)

        trainer_mod.save_checkpoint = counted_save
        init = torch.load(init_path)
        for name, kw, sigterm_at in jobs:
            saves.clear()
            metrics = []

            def hook(step, m):
                metrics.append(m)
                # the last rank alone is told to stop
                if step == sigterm_at and rank == world - 1:
                    os.kill(os.getpid(), signal.SIGTERM)

            trainer = Trainer(TrainConfig(**kw), DistilBertConfig.tiny(
                dropout=0.0, attention_dropout=0.0), device="cpu")
            state = trainer.train(tiny_dataset(NwayDataset, HashTokenizer),
                                  init_params=init, step_hook=hook)
            torch.save({"metrics": metrics, "params": state.params,
                        "step": state.step, "saves": list(saves),
                        "world": trainer.world},
                       os.path.join(out_dir, f"{name}.rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_group(world, jobs, init_params, out_dir):
    """Run ``jobs`` ((name, TrainConfig kwargs, step at which the last
    rank gets SIGTERM or None), in order) on ``world`` gloo ranks from
    ``init_params``; returns {name: [each rank's record]}."""
    init_path = os.path.join(out_dir, "init.pt")
    torch.save(init_params, init_path)
    mp.start_processes(_train_rank, args=(world, _free_port(), jobs,
                                          init_path, out_dir),
                       nprocs=world, start_method="spawn")
    return {name: [torch.load(os.path.join(out_dir, f"{name}.rank{r}.pt"))
                   for r in range(world)] for name, _, _ in jobs}


def _curriculum_rank(rank, world, port, argv, start, group_timeout_s,
                     eval_delay_s, out_dir):
    torch.set_num_threads(1)
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank), MASTER_ADDR="127.0.0.1",
                      MASTER_PORT=str(port))
    # the default group (the CLI's own bring-up) times out after
    # group_timeout_s; the ranks start it together
    dist.init_process_group = functools.partial(
        dist.init_process_group,
        timeout=datetime.timedelta(seconds=group_timeout_s))
    from cldrd_tpu_torch.cli import curriculum
    from cldrd_tpu_torch.evaluation import RankingEvaluator

    evaluations = []
    real = RankingEvaluator.compute_metrics

    def slow_first(self, *args, **kwargs):
        # rank 0's first evaluation outlasts the default group's timeout
        if not evaluations:
            time.sleep(eval_delay_s)
        evaluations.append(1)
        return real(self, *args, **kwargs)

    RankingEvaluator.compute_metrics = slow_first
    start.wait()
    rc = curriculum.main(argv)
    with open(os.path.join(out_dir, f"curriculum.rank{rank}.json"),
              "w") as f:
        json.dump({"rc": rc, "evaluations": len(evaluations),
                   "world": dist.get_world_size()}, f)
    dist.destroy_process_group()


def run_curriculum(world, argv, group_timeout_s, eval_delay_s, out_dir):
    """``cli.curriculum.main(argv)`` on ``world`` gloo ranks joined
    through torchrun's variables, the default group's timeout cut to
    ``group_timeout_s`` and rank 0's first evaluation held for
    ``eval_delay_s``; returns each rank's {rc, evaluations, world}."""
    start = mp.get_context("spawn").Barrier(world)
    mp.start_processes(_curriculum_rank,
                       args=(world, _free_port(), argv, start,
                             group_timeout_s, eval_delay_s, out_dir),
                       nprocs=world, start_method="spawn")
    out = []
    for r in range(world):
        with open(os.path.join(out_dir, f"curriculum.rank{r}.json")) as f:
            out.append(json.load(f))
    return out
