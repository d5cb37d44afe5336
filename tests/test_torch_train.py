"""The port's training path (losses, optimizer, Trainer, checkpoints,
curriculum, CLIs) held to cldrd_tpu on the CPU, on numpy-seeded inputs
and the same initial weights (``params_from_flax``).

Tolerances, with their reasons:
- losses and their gradients: 1e-5 relative (fp32, other reduction
  orders);
- optimizer: params within 1e-6 relative + 1e-6 absolute (1e-4 of an
  lr-1e-2 step) after six updates (fp32 Adam, the same formula in
  another operation order);
- Trainer parity (dropout 0, fp32): every step's loss to 1e-4 relative;
  the final params to 1e-4 relative in norm over all tensors; each
  element within 1e-4 relative plus a tenth of an Adam step (0.1 * lr),
  and within ``updates * lr`` where exact arithmetic gives a zero
  gradient (key biases, and with a shift-invariant ranking loss the
  passage tower's last LayerNorm bias): Adam normalizes the rounding
  noise of a near-zero gradient towards a full step.
"""
import argparse
import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from cldrd_tpu import losses as JL
from cldrd_tpu.data.nway_dataset import NwayDataset as JaxDataset
from cldrd_tpu.data.packing import pack_nway_batch as jax_pack
from cldrd_tpu.data.tokenization import HashTokenizer as JaxTokenizer
from cldrd_tpu.losses.lambda_loss import SCHEMES
from cldrd_tpu.models import DistilBertConfig as JaxConfig
from cldrd_tpu.models import NwayDualEncoder as JaxDualEncoder
from cldrd_tpu.parallel import make_mesh
from cldrd_tpu.train import TrainConfig as JaxTrainConfig
from cldrd_tpu.train import Trainer as JaxTrainer
from cldrd_tpu.train import batch_mrr_recall as jax_batch_mrr
from cldrd_tpu.train import curriculum_iterations as jax_curriculum
from cldrd_tpu.train.checkpoint import load_warm_start_params as jax_warm
from cldrd_tpu.train.optim import make_optimizer
from cldrd_tpu.utils import write_train_logs as jax_write_logs
from cldrd_tpu_torch import losses as TL
from cldrd_tpu_torch.cli import curriculum as cli_curriculum
from cldrd_tpu_torch.cli import train as cli_train
from cldrd_tpu_torch.cli.common import add_model_args, model_config_from_args
from cldrd_tpu_torch.data import HashTokenizer, NwayDataset, pack_nway_batch
from cldrd_tpu_torch.models import DistilBertConfig, params_from_flax
from cldrd_tpu_torch.train import (
    TrainConfig,
    Trainer,
    batch_mrr_recall,
    curriculum_iterations,
    latest_checkpoint,
    load_checkpoint,
    run_curriculum,
)
from cldrd_tpu_torch.train.optim import Optimizer, decays
from cldrd_tpu_torch.utils import write_train_logs

# ------------------------------------------------------------------ losses


def _scores(rng, bz=4, n=10):
    pred = rng.standard_normal((bz, n)).astype(np.float32)
    true = rng.choice([1.0, 0.5, 0.2, -0.25, -0.5, 0.0],
                      size=(bz, n)).astype(np.float32)
    true[0, -2:] = -1.0  # padded positions join no pair
    return pred, true


_LOSSES = [
    ("lambda_mrr", {}), ("lambda_mrr", {"reduction": "sum"}),
    ("ranknet", {}), ("margin_mse", {}), ("kl_div", {"T": 2.0}),
    ("weighted_pointwise", {"T": 3.0}), ("bweight", {}),
    *[("lambda_loss", {"weighing_scheme": s}) for s in SCHEMES],
    ("lambda_loss", {"weighing_scheme": "ndcgLoss2PP_scheme", "k": 4}),
    ("lambda_loss", {"weighing_scheme": None, "reduction": "sum",
                     "reduction_log": "binary"}),
    ("lambda_loss", {"weighing_scheme": "lambdaRank_scheme",
                     "gain": "linear"}),
]


@pytest.mark.parametrize("name,kw", _LOSSES,
                         ids=[f"{n}-{i}" for i, (n, _) in enumerate(_LOSSES)])
def test_losses_match_reference(name, kw):
    rng = np.random.default_rng(0)
    pred, true = _scores(rng)
    weight = rng.uniform(0.5, 2.0, pred.shape[0]).astype(np.float32)
    jfn = {"lambda_mrr": JL.lambda_mrr_loss, "ranknet": JL.ranknet_loss,
           "margin_mse": JL.margin_mse_loss, "kl_div": JL.kl_div_loss,
           "weighted_pointwise": JL.weighted_pointwise_loss,
           "lambda_loss": JL.lambda_loss,
           "bweight": lambda p, t: JL.bweight_lambda_mrr_loss(
               p, t, jnp.asarray(weight))}[name]
    tfn = {"lambda_mrr": TL.lambda_mrr_loss, "ranknet": TL.ranknet_loss,
           "margin_mse": TL.margin_mse_loss, "kl_div": TL.kl_div_loss,
           "weighted_pointwise": TL.weighted_pointwise_loss,
           "lambda_loss": TL.lambda_loss,
           "bweight": lambda p, t: TL.bweight_lambda_mrr_loss(
               p, t, torch.from_numpy(weight))}[name]
    jv, jg = jax.value_and_grad(lambda p: jfn(p, jnp.asarray(true), **kw))(
        jnp.asarray(pred))
    tp = torch.from_numpy(pred).requires_grad_()
    tv = tfn(tp, torch.from_numpy(true), **kw)
    tv.backward()
    assert float(tv.detach()) == pytest.approx(float(jv), rel=1e-5, abs=1e-7)
    scale = max(np.abs(np.asarray(jg)).max(), 1e-12)
    assert np.abs(tp.grad.numpy() - np.asarray(jg)).max() <= 1e-5 * scale


def test_batch_mrr_recall_matches_reference():
    rng = np.random.default_rng(1)
    logits = rng.standard_normal((4, 12)).astype(np.float32)
    logits[1, 3] = logits[1, 5]  # a tie: stable order decides
    labels = np.full((4, 12), -0.25, np.float32)
    labels[np.arange(4), rng.integers(0, 12, 4)] = 1.0
    labels[1, 5] = 1.0
    j = jax_batch_mrr(jnp.asarray(logits), jnp.asarray(labels))
    t = batch_mrr_recall(torch.from_numpy(logits), torch.from_numpy(labels))
    for a, b in zip(t, j):
        assert float(a) == pytest.approx(float(b), abs=1e-7)


# --------------------------------------------------------------- optimizer


def _flax_params(seed=0, share=False):
    model = JaxDualEncoder(config=JaxConfig.tiny(), share_weights=share)
    dq = {"input_ids": jnp.zeros((1, 8), jnp.int32),
          "attention_mask": jnp.ones((1, 8), jnp.int32)}
    dp = {"input_ids": jnp.zeros((1, 1, 8), jnp.int32),
          "attention_mask": jnp.ones((1, 1, 8), jnp.int32)}
    params = model.init(jax.random.PRNGKey(seed), dq, dp)["params"]
    return jax.tree_util.tree_map(np.asarray, params)


@pytest.mark.parametrize("accum", [1, 2])
def test_optimizer_matches_make_optimizer(accum):
    """Clip (large grads trigger it), AdamW with the decay mask, the HF
    schedule (lr 0 at the first update) and MultiSteps accumulation,
    over six micro-steps of random gradients."""
    params = _flax_params()
    rng = np.random.default_rng(2)
    lr, total, warmup = 1e-2, 3, 1
    opt = make_optimizer(lr, total, warmup_steps=warmup, weight_decay=0.1,
                         max_grad_norm=1.0)
    if accum > 1:
        opt = optax.MultiSteps(opt, every_k_schedule=accum)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    state = opt.init(jp)
    sd = params_from_flax(params)
    names = list(sd)
    tparams = [torch.nn.Parameter(sd[n].clone()) for n in names]
    topt = Optimizer(list(zip(names, tparams)), lr, total,
                     warmup_steps=warmup, weight_decay=0.1,
                     max_grad_norm=1.0, grad_accum_steps=accum)
    for step in range(6):
        scale = 10.0 if step % 2 else 1e-3
        grads = jax.tree_util.tree_map(
            lambda x: (rng.standard_normal(x.shape) * scale).astype(
                np.float32), params)
        updates, state = opt.update(
            jax.tree_util.tree_map(jnp.asarray, grads), state, jp)
        jp = optax.apply_updates(jp, updates)
        tg = params_from_flax(grads)
        with torch.no_grad():
            topt.step([tg[n] for n in names])
    ref = params_from_flax(jax.tree_util.tree_map(np.asarray, jp))
    moved = 0
    for n, p in zip(names, tparams):
        np.testing.assert_allclose(p.detach().numpy(), ref[n].numpy(),
                                   rtol=1e-6, atol=1e-6, err_msg=n)
        moved += not np.array_equal(ref[n].numpy(), sd[n].numpy())
    assert moved == len(names)


def test_decay_mask_matches_reference_filter():
    assert not decays("query_encoder.embeddings.LayerNorm.weight")
    assert not decays("passage_encoder.transformer.layer.0.ffn.lin1.bias")
    assert decays("query_encoder.transformer.layer.1.sa_layer_norm.weight")
    assert decays("query_encoder.embeddings.word_embeddings.weight")


# ------------------------------------------------------ training parity


def _dataset(cls, tok_cls, n=16):
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


def _cfg_kw(tmp_path, **overrides):
    kw = dict(label_mode="1", batch_size=8, num_train_epochs=2,
              learning_rate=1e-4, warmup_steps=1, logging_steps=1,
              evaluate_steps=100, max_query_len=12, max_passage_len=16,
              compute_dtype="float32", seed=0, run_folder=str(tmp_path),
              pack_passages=False)
    kw.update(overrides)
    return kw


# tensors whose gradient is zero in exact arithmetic (see the docstring)
_ZERO_GRAD = ("attention.k_lin.bias",
              "passage_encoder.transformer.layer.1.output_layer_norm.bias")


@pytest.mark.parametrize("mode", ["flat", "packed", "in_batch", "accum"])
def test_trainer_matches_reference(tmp_path, mode):
    overrides = {"flat": {}, "packed": {"pack_passages": True},
                 "in_batch": {"in_batch_loss": True},
                 "accum": {"grad_accum_steps": 2}}[mode]
    kw = _cfg_kw(tmp_path, experiment_name=mode, **overrides)
    jcfg = JaxConfig.tiny(dropout=0.0, attention_dropout=0.0)
    jt = JaxTrainer(JaxTrainConfig(**kw), jcfg, mesh=make_mesh(1))
    init = jax.tree_util.tree_map(np.asarray,
                                  jt.init_state(4, seed=0).params)
    jl = []
    js = jt.train(_dataset(JaxDataset, JaxTokenizer),
                  init_params=jax.tree_util.tree_map(jnp.asarray, init),
                  step_hook=lambda s, m: jl.append(m["loss"]))
    kw["run_folder"] = str(tmp_path / "port")
    tt = Trainer(TrainConfig(**kw),
                 DistilBertConfig.tiny(dropout=0.0, attention_dropout=0.0),
                 device="cpu")
    tl = []
    ts = tt.train(_dataset(NwayDataset, HashTokenizer),
                  init_params=params_from_flax(init),
                  step_hook=lambda s, m: tl.append(m["loss"]))
    assert len(tl) == len(jl) == 4 and ts.step == 4
    np.testing.assert_allclose(tl, jl, rtol=1e-4)
    ref = params_from_flax(jax.tree_util.tree_map(np.asarray, js.params))
    updates = 4 // kw.get("grad_accum_steps", 1)
    diff = sum(float(np.sum((ts.params[k].numpy() - v.numpy()) ** 2))
               for k, v in ref.items())
    norm = sum(float(np.sum(v.numpy() ** 2)) for v in ref.values())
    assert np.sqrt(diff / norm) < 1e-4
    for k, v in ref.items():
        atol = kw["learning_rate"] * (updates if k.endswith(_ZERO_GRAD)
                                      else 0.1)
        np.testing.assert_allclose(ts.params[k].numpy(), v.numpy(),
                                   rtol=1e-4, atol=atol, err_msg=k)


def test_straight_and_resumed_training_agree(tmp_path):
    """With dropout on: a run resumed from its mid-epoch checkpoint ends
    with the uninterrupted run's params, bit for bit."""
    cfg_model = DistilBertConfig.tiny(attention_impl="pallas")
    kw = _cfg_kw(tmp_path, evaluate_steps=1, learning_rate=1e-3)
    full = Trainer(TrainConfig(experiment_name="full", tensorboard=True,
                               **kw), cfg_model, device="cpu")
    s_full = full.train(_dataset(NwayDataset, HashTokenizer))
    ckpt = os.path.join(full.run_dir, "checkpoint_3.pth.tar")
    blob = load_checkpoint(ckpt)
    assert set(blob) == {"state_dict", "optimizer", "scheduler", "step",
                         "epoch"} and blob["step"] == 3
    kw["evaluate_steps"] = 100
    res = Trainer(TrainConfig(experiment_name="res", resume=ckpt, **kw),
                  cfg_model, device="cpu")
    seen = []
    s_res = res.train(_dataset(NwayDataset, HashTokenizer),
                      step_hook=lambda s, m: seen.append(s))
    assert seen == [4] and s_res.step == 4
    for k, v in s_full.params.items():
        assert torch.equal(v, s_res.params[k]), k
    assert latest_checkpoint(res.run_dir).endswith("checkpoint_4.pth.tar")
    assert os.listdir(os.path.join(full.run_dir, "tb"))


@pytest.mark.parametrize("share", [False, True])
def test_reference_reads_the_ports_checkpoint(tmp_path, share):
    """cldrd_tpu's warm start reads a port checkpoint to equal weights."""
    kw = _cfg_kw(tmp_path, num_train_epochs=1, share_weights=share)
    t = Trainer(TrainConfig(experiment_name="w", **kw),
                DistilBertConfig.tiny(), device="cpu")
    state = t.train(_dataset(NwayDataset, HashTokenizer))
    path = latest_checkpoint(t.run_dir)
    template = _flax_params(share=share)
    got = params_from_flax(jax.tree_util.tree_map(
        np.asarray, jax_warm(path, template, share_weights=share)))
    for k, v in got.items():
        np.testing.assert_array_equal(v.numpy(), state.params[k].numpy(),
                                      err_msg=k)


def test_run_curriculum_hands_off_weights(tmp_path):
    iters = [TrainConfig(**_cfg_kw(tmp_path, experiment_name=f"c{i}",
                                   num_train_epochs=1))
             for i in (1, 2)]
    calls, first = [], {}

    def hook(i, state, trainer):
        calls.append((i, state.step))
        first.setdefault(i, {k: v.clone() for k, v in state.params.items()})

    dataset = _dataset(NwayDataset, HashTokenizer)
    state = run_curriculum(iters, DistilBertConfig.tiny(),
                           lambda cfg: dataset, device="cpu",
                           after_iteration=hook)
    assert calls == [(0, 2), (1, 2)]
    assert os.path.exists(tmp_path / "c2" / "train_logs.log")
    changed = any(not torch.equal(first[0][k], state.params[k])
                  for k in state.params)
    assert changed


def test_train_logs_are_byte_compatible(tmp_path):
    for fn, name in ((jax_write_logs, "j"), (write_train_logs, "t")):
        for step in (1, 2):
            fn(1, step, 0.25 / step, 0.5, 0.75, 1e-5 * step,
               filename=str(tmp_path / name), reg_loss=0.01,
               total_aux_ratio=0.04)
    for suffix in ("", ".jsonl"):
        assert (tmp_path / f"j{suffix}").read_bytes() == \
            (tmp_path / f"t{suffix}").read_bytes()


def test_packing_matches_reference():
    rng = np.random.default_rng(3)
    ids = rng.integers(3, 100, (3, 30, 32)).astype(np.int32)
    lens = rng.integers(1, 33, (3, 30))
    mask = (np.arange(32)[None, None] < lens[..., None]).astype(np.int32)
    j, t = jax_pack(ids * mask, mask), pack_nway_batch(ids * mask, mask)
    for k, v in j.as_dict().items():
        np.testing.assert_array_equal(t.as_dict()[k], v, err_msg=k)


def test_config_yaml_and_curriculum_match_reference(tmp_path):
    """A config written by either package reads back equal in both; the
    curriculum's three iterations are the reference's."""
    cfg = TrainConfig(label_mode="9", learning_rate=3e-6, loss_at_k=5,
                      model_checkpoint="/x/y.pth.tar", pack_passages=True)
    cfg.save_yaml(str(tmp_path / "t.yaml"))
    JaxTrainConfig(**cfg.to_dict()).save_yaml(str(tmp_path / "j.yaml"))
    assert (tmp_path / "t.yaml").read_text() == \
        (tmp_path / "j.yaml").read_text()
    assert JaxTrainConfig.from_yaml(str(tmp_path / "t.yaml")).to_dict() == \
        TrainConfig.from_yaml(str(tmp_path / "t.yaml")).to_dict()
    ours = [c.to_dict() for c in curriculum_iterations(cfg)]
    ref = [c.to_dict() for c in jax_curriculum(JaxTrainConfig(
        **cfg.to_dict()))]
    assert ours == ref


def test_trainer_refuses_what_is_not_ported(tmp_path):
    # n_devices must equal the process group's ranks (1 without a group)
    with pytest.raises(ValueError, match="process group has 1 rank"):
        Trainer(TrainConfig(**_cfg_kw(tmp_path, n_devices=2)),
                DistilBertConfig.tiny(), device="cpu")
    t = Trainer(TrainConfig(**_cfg_kw(tmp_path, n_devices=1)),
                DistilBertConfig.tiny(), device="cpu")
    assert t.world == 1 and not t.model_config.remat
    # cfg.remat turns on the model's remat, as in the reference
    t = Trainer(TrainConfig(**_cfg_kw(tmp_path, remat=True)),
                DistilBertConfig.tiny(), device="cpu")
    assert t.model_config.remat
    assert TrainConfig().resolve().pack_passages is False


# -------------------------------------------------------------------- CLIs


def _write_corpus(work, rng):
    words = [f"w{i}" for i in range(300)]
    paths = {k: str(work / f"{k}.tsv") for k in ("c", "q", "qrels")}
    with open(paths["c"], "w") as f:
        for p in range(400):
            f.write(f"{p}\t{' '.join(rng.choice(words, rng.integers(3, 12)))}\n")
    with open(paths["q"], "w") as f, open(paths["qrels"], "w") as fr:
        for q in range(16):
            f.write(f"{q}\t{' '.join(rng.choice(words, 4))}\n")
            fr.write(f"{q}\t0\t{q}\t1\n")
    for mode, (r, n) in {"8": (5, 25), "9": (10, 20), "10": (20, 10)}.items():
        with open(work / f"it{mode}.jsonl", "w") as f:
            for q in range(16):
                pids = rng.choice(400, r + n, replace=False).tolist()
                f.write(json.dumps({
                    "qid": q, "relT_pids": pids[:r],
                    "most_hard_pids": pids[r:r + n // 2],
                    "semi_hard_pids": pids[r + n // 2:]}) + "\n")
    (work / "base.yaml").write_text(
        "max_query_len: 12\nmax_passage_len: 32\nwarmup_steps: 1\n"
        "logging_steps: 1\nevaluate_steps: 1\ncompute_dtype: \"float32\"\n")
    return paths


def test_cli_curriculum_and_train(tmp_path):
    """cli.curriculum over the three curriculum label modes with the
    per-iteration evaluation, then cli.train packed with the attention
    kernels' plain versions, and a resume that replays its last step."""
    paths = _write_corpus(tmp_path, np.random.default_rng(4))
    runs = tmp_path / "runs"
    model = ["--model-size", "tiny", "--device", "cpu",
             "--config", str(tmp_path / "base.yaml")]
    assert cli_curriculum.main([
        "--queries", paths["q"], "--passages", paths["c"],
        "--training-paths", *(str(tmp_path / f"it{m}.jsonl")
                              for m in ("8", "9", "10")),
        "--epochs", "1", "1", "1", "--learning-rates", "1e-4", "1e-4",
        "1e-4", "--batch-size", "8", "--run-folder", str(runs),
        "--eval-queries", paths["q"], "--eval-qrels", paths["qrels"],
        "--eval-topk", "10", *model]) == 0
    table = (runs / "curriculum_eval.tsv").read_text().splitlines()
    assert table[0].startswith("step\tMRR@10") and len(table) == 4
    train = ["--queries-path", paths["q"], "--passages-path", paths["c"],
             "--training-path", str(tmp_path / "it8.jsonl"),
             "--label-mode", "8", "--batch-size", "8",
             "--num-train-epochs", "1", "--run-folder", str(runs),
             "--pack-passages", "--attention-impl", "pallas",
             "--attention-dropout", "0.1", *model]
    assert cli_train.main([*train, "--experiment-name", "packed"]) == 0
    assert cli_train.main([
        *train, "--experiment-name", "resumed", "--resume",
        str(runs / "packed" / "checkpoint_1.pth.tar")]) == 0
    full = (runs / "packed" / "train_logs.log").read_text().splitlines()
    res = (runs / "resumed" / "train_logs.log").read_text().splitlines()
    assert res[1:] == full[2:] and len(full) == 3
    assert "pack_passages: true" in (runs / "packed" / "config.yaml"
                                     ).read_text()
    # a warm start from a flax .msgpack (a JAX init, in a Trainer
    # checkpoint's layout) reads exactly those weights
    from flax import serialization

    from cldrd_tpu_torch.models.convert import params_from_flax
    from cldrd_tpu_torch.train import load_warm_start_params

    ids = jnp.ones((1, 8), jnp.int32)
    params = JaxDualEncoder(JaxConfig.tiny()).init(
        jax.random.PRNGKey(3), {"input_ids": ids, "attention_mask": ids},
        {"input_ids": ids[:, None], "attention_mask": ids[:, None]}
    )["params"]
    path = str(tmp_path / "x.msgpack")
    with open(path, "wb") as f:
        f.write(serialization.msgpack_serialize(
            {"params": params, "step": np.int32(5)}))
    loaded = load_warm_start_params(path)
    want = params_from_flax(jax.tree_util.tree_map(np.asarray, params))
    assert loaded.keys() == want.keys()
    assert all(torch.equal(loaded[k], want[k]) for k in want)
    assert cli_train.main([*train, "--experiment-name", "m",
                           "--model-checkpoint", path]) == 0


def test_model_config_flags_mean_what_they_mean_in_the_reference():
    """A reference --model-config (its keys, attention_impl included)
    reads into the port's config; options the port lacks raise unless at
    their defaults; --attention-impl and the dropout flags override."""
    parser = argparse.ArgumentParser()
    add_model_args(parser, train=True)
    ref = dataclasses.asdict(JaxConfig.tiny(attention_impl="pallas"))
    args = parser.parse_args(["--model-config", json.dumps(ref),
                              "--dropout", "0.2"])
    cfg = model_config_from_args(args)
    assert cfg.attention_impl == "pallas" and cfg.dropout == 0.2
    assert cfg.dim == ref["dim"] and cfg.attention_dropout == 0.1
    args = parser.parse_args(["--model-size", "tiny", "--attention-impl",
                              "xla", "--attention-dropout", "0.0"])
    cfg = model_config_from_args(args)
    assert (cfg.attention_impl, cfg.attention_dropout) == ("xla", 0.0)
    # the encoder's memory and speed options read as the reference's keys
    opts = {"fused_qkv": True, "softmax_in_compute_dtype": True,
            "remat": True, "remat_policy": "dots"}
    cfg = model_config_from_args(parser.parse_args(
        ["--model-config", json.dumps({**ref, **opts})]))
    assert {k: getattr(cfg, k) for k in opts} == opts


def test_sigterm_checkpoints_at_the_step_boundary_and_resumes(tmp_path):
    """SIGTERM during a step: the trainer finishes the step, saves one
    checkpoint and returns; resuming from it ends with the uninterrupted
    run's params."""
    import signal

    kw = _cfg_kw(tmp_path, learning_rate=1e-3)
    cfg_model = DistilBertConfig.tiny()
    full = Trainer(TrainConfig(experiment_name="full", **kw), cfg_model,
                   device="cpu").train(_dataset(NwayDataset, HashTokenizer))

    def hook(step, m):
        if step == 1:
            os.kill(os.getpid(), signal.SIGTERM)

    t = Trainer(TrainConfig(experiment_name="pre", **kw), cfg_model,
                device="cpu")
    state = t.train(_dataset(NwayDataset, HashTokenizer), step_hook=hook)
    assert state.step == 1
    assert latest_checkpoint(t.run_dir).endswith("checkpoint_1.pth.tar")
    assert signal.getsignal(signal.SIGTERM) is not None
    res = Trainer(TrainConfig(experiment_name="res",
                              resume=latest_checkpoint(t.run_dir), **kw),
                  cfg_model, device="cpu").train(
        _dataset(NwayDataset, HashTokenizer))
    for k, v in full.params.items():
        assert torch.equal(v, res.params[k]), k


@pytest.mark.parametrize("policy", ["raise", "warn"])
def test_nan_policy(tmp_path, monkeypatch, policy):
    from cldrd_tpu_torch.train import trainer as trainer_mod

    def nan_loss(cfg):
        return lambda logits, labels, teacher: logits.sum() * float("nan")

    monkeypatch.setattr(trainer_mod, "make_loss_fn", nan_loss)
    t = Trainer(TrainConfig(**_cfg_kw(tmp_path, nan_policy=policy,
                                      num_train_epochs=1)),
                DistilBertConfig.tiny(), device="cpu")
    if policy == "raise":
        with pytest.raises(FloatingPointError, match="non-finite loss"):
            t.train(_dataset(NwayDataset, HashTokenizer))
    else:
        assert t.train(_dataset(NwayDataset, HashTokenizer)).step == 2


def test_first_batch_token_range_is_checked(tmp_path):
    """Token ids past the model's vocabulary fail before the first step."""
    t = Trainer(TrainConfig(**_cfg_kw(tmp_path)),
                DistilBertConfig.tiny(vocab_size=256), device="cpu")
    with pytest.raises(ValueError, match="vocab_size"):
        t.train(_dataset(NwayDataset, HashTokenizer))
