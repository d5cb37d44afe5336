"""The encoder's memory and speed options (``fused_qkv``,
``softmax_in_compute_dtype``, ``remat`` with ``remat_policy``) and the
resume of a JAX run with gradient accumulation, held to cldrd_tpu on the
CPU on numpy-seeded inputs and the same weights (``params_from_flax``).

Tolerances, with their reasons:
- ``fused_qkv`` (fp32): 1e-5 absolute, the reference's own bound for the
  fused form against the split one;
- ``softmax_in_compute_dtype`` (bf16): 0.05 relative and absolute and a
  cosine above 0.999 per embedding, the reference's bound (bf16 rounds
  at other places in the two frameworks);
- remat against no remat (dropout 0.1): losses to 1e-5 relative, as the
  reference asks of its remat; gradients to 1e-5 relative + 1e-7
  absolute (the same forward recomputed, other operation orders);
- remat against JAX remat (dropout 0, fp32): logits to 1e-5 relative,
  gradients to 1e-4 relative + 1e-6 absolute;
- the resumed accumulation run: the Trainer parity bounds of
  ``tests/test_torch_train.py``.
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cldrd_tpu.data.nway_dataset import NwayDataset as JaxDataset
from cldrd_tpu.data.tokenization import HashTokenizer as JaxTokenizer
from cldrd_tpu.models import DistilBertConfig as JaxConfig
from cldrd_tpu.models import NwayDualEncoder as JaxDualEncoder
from cldrd_tpu.models.bert import BertConfig as JaxBertConfig
from cldrd_tpu.models.bert import BertEncoder as JaxBertEncoder
from cldrd_tpu.parallel import make_mesh
from cldrd_tpu.train import TrainConfig as JaxTrainConfig
from cldrd_tpu.train import Trainer as JaxTrainer
from cldrd_tpu_torch.data import HashTokenizer, NwayDataset
from cldrd_tpu_torch.models import (
    BertConfig,
    DistilBertConfig,
    DropoutRNG,
    NwayDualEncoder,
    params_from_flax,
)
from cldrd_tpu_torch.models import distilbert as tdistil
from cldrd_tpu_torch.models.bert import BertEncoder
from cldrd_tpu_torch.models.convert import tower_from_flax
from cldrd_tpu_torch.train import TrainConfig, Trainer


def _flax_params(cfg, seed=0):
    model = JaxDualEncoder(config=cfg)
    dq = {"input_ids": jnp.zeros((1, 8), jnp.int32),
          "attention_mask": jnp.ones((1, 8), jnp.int32)}
    dp = {"input_ids": jnp.zeros((1, 1, 8), jnp.int32),
          "attention_mask": jnp.ones((1, 1, 8), jnp.int32)}
    params = model.init(jax.random.PRNGKey(seed), dq, dp)["params"]
    return jax.tree_util.tree_map(np.asarray, params)


def _tokens(rng, shape, length, vocab=512):
    ids = rng.integers(3, vocab, (*shape, length)).astype(np.int32)
    lens = rng.integers(2, length + 1, shape)
    mask = (np.arange(length) < lens[..., None]).astype(np.int32)
    ids[..., 0] = 1
    return {"input_ids": ids * mask, "attention_mask": mask}


def _batch(seed=0, bz=4, nway=3):
    rng = np.random.default_rng(seed)
    return _tokens(rng, (bz,), 12), _tokens(rng, (bz, nway), 16)


def _torch(tokens):
    return {k: torch.from_numpy(v).long() for k, v in tokens.items()}


def _jax(tokens):
    return {k: jnp.asarray(v) for k, v in tokens.items()}


# ---------------------------------------------------------------- fused_qkv


@pytest.mark.parametrize("arch", ["distilbert", "bert"])
def test_fused_qkv_matches_reference(arch):
    """The same state_dict keys either way; the fused form's hidden states
    equal the reference's fused form on the same params (and the split
    form's), cls_only included."""
    if arch == "bert":
        jcfg, tcfg = JaxBertConfig.tiny(), BertConfig.tiny()
        jenc = JaxBertEncoder(dataclasses.replace(jcfg, fused_qkv=True))
        tenc_cls = BertEncoder
    else:
        jcfg, tcfg = JaxConfig.tiny(), DistilBertConfig.tiny()
        from cldrd_tpu.models.distilbert import DistilBertEncoder as JEnc
        jenc = JEnc(dataclasses.replace(jcfg, fused_qkv=True))
        tenc_cls = tdistil.DistilBertEncoder
    toks = _tokens(np.random.default_rng(1), (4,), 16)
    params = jax.tree_util.tree_map(np.asarray, jenc.init(
        jax.random.PRNGKey(0), jnp.asarray(toks["input_ids"]),
        jnp.asarray(toks["attention_mask"]))["params"])
    plain = tenc_cls(tcfg)
    fused = tenc_cls(dataclasses.replace(tcfg, fused_qkv=True))
    sd = tower_from_flax(params)
    assert set(plain.state_dict()) == set(fused.state_dict()) == set(sd)
    plain.load_state_dict(sd)
    fused.load_state_dict(sd)
    for cls_only in (False, True):
        ref = np.asarray(jenc.apply(
            {"params": params}, jnp.asarray(toks["input_ids"]),
            jnp.asarray(toks["attention_mask"]), cls_only=cls_only))
        with torch.no_grad():
            got = fused(*_torch(toks).values(), cls_only=cls_only).numpy()
            split = plain(*_torch(toks).values(), cls_only=cls_only).numpy()
        np.testing.assert_allclose(got, ref, atol=1e-5)
        np.testing.assert_allclose(got, split, atol=1e-5)


def test_softmax_in_compute_dtype_matches_reference():
    from cldrd_tpu.models.distilbert import DistilBertEncoder as JEnc

    jcfg = dataclasses.replace(JaxConfig.tiny(), softmax_in_compute_dtype=True)
    jenc = JEnc(jcfg, dtype=jnp.bfloat16)
    toks = _tokens(np.random.default_rng(2), (4,), 16)
    params = jax.tree_util.tree_map(np.asarray, jenc.init(
        jax.random.PRNGKey(0), jnp.asarray(toks["input_ids"]),
        jnp.asarray(toks["attention_mask"]))["params"])
    tenc = tdistil.DistilBertEncoder(dataclasses.replace(
        DistilBertConfig.tiny(), softmax_in_compute_dtype=True),
        dtype=torch.bfloat16)
    tenc.load_state_dict(tower_from_flax(params))
    for cls_only in (False, True):
        ref = np.asarray(jenc.apply(
            {"params": params}, jnp.asarray(toks["input_ids"]),
            jnp.asarray(toks["attention_mask"]), cls_only=cls_only),
            dtype=np.float32)
        with torch.no_grad():
            got = tenc(*_torch(toks).values(),
                       cls_only=cls_only).float().numpy()
        np.testing.assert_allclose(got, ref, atol=0.05, rtol=0.05)
        cos = (got * ref).sum(-1) / (np.linalg.norm(got, axis=-1)
                                     * np.linalg.norm(ref, axis=-1))
        assert float(cos.min()) > 0.999, cls_only


# -------------------------------------------------------------------- remat


def _loss_and_grads(model, q, p, rng):
    logits = model(q, p, rng=rng)
    loss = torch.log_softmax(logits, -1)[:, 0].neg().mean() + \
        1e-3 * logits.square().sum()
    params = [v for _, v in model.named_parameters()]
    grads = torch.autograd.grad(loss, params, allow_unused=True)
    return loss.item(), [torch.zeros_like(v) if g is None else g
                         for v, g in zip(params, grads)]


def _remat_model(policy, impl, params):
    cfg = DistilBertConfig.tiny(attention_impl=impl,
                                remat=policy is not None,
                                remat_policy=policy or "full")
    model = NwayDualEncoder(cfg)
    model.load_state_dict(params)
    return model.train()


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_remat_replays_dropout(impl, monkeypatch):
    """With dropout 0.1 (hidden and attention probs; 'pallas' takes the
    counter-hash kernel's plain version with its host seed), remat 'full'
    and 'dots' give the no-remat loss and gradients. A replay that draws
    fresh masks in the recompute gives other gradients, and the same
    comparison catches it."""
    params = params_from_flax(_flax_params(JaxConfig.tiny()))
    q, p = map(_torch, _batch())
    loss0, g0 = _loss_and_grads(_remat_model(None, impl, params), q, p,
                                DropoutRNG(0, 3, "cpu"))
    for policy in ("full", "dots"):
        loss, g = _loss_and_grads(_remat_model(policy, impl, params), q, p,
                                  DropoutRNG(0, 3, "cpu"))
        np.testing.assert_allclose(loss, loss0, rtol=1e-5)
        for a, b in zip(g, g0):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5,
                                       atol=1e-7)

    # a broken replay: the recompute draws on from the step's generator
    # and host stream instead of restoring them
    def fresh(self):
        self._runs += 1
        self._pos = 0
        self.generator = self._rng.generator

    def fresh_seed(self):
        return self._rng.next_seed()

    monkeypatch.setattr(tdistil._ReplayRNG, "begin", fresh)
    monkeypatch.setattr(tdistil._ReplayRNG, "next_seed", fresh_seed)
    loss, g = _loss_and_grads(_remat_model("full", impl, params), q, p,
                              DropoutRNG(0, 3, "cpu"))
    np.testing.assert_allclose(loss, loss0, rtol=1e-5)  # forward unchanged
    worst = max(float((a - b).abs().max() / b.abs().max().clamp(min=1e-12))
                for a, b in zip(g, g0))
    assert worst > 1e-3, worst


def test_remat_matches_reference_remat():
    """remat 'full' and 'dots' at dropout 0 against the reference's
    ``nn.remat`` encoder: logits and gradients of the same loss."""
    jcfg = JaxConfig.tiny(dropout=0.0, attention_dropout=0.0, remat=True)
    flax = _flax_params(jcfg)
    q, p = _batch(1)
    jm = JaxDualEncoder(config=jcfg)

    def jloss(prm):
        logits = jm.apply({"params": prm}, _jax(q), _jax(p),
                          deterministic=False)
        return (-jax.nn.log_softmax(logits, -1)[:, 0].mean()
                + 1e-3 * jnp.sum(logits ** 2)), logits

    (jl, jlogits), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        jax.tree_util.tree_map(jnp.asarray, flax))
    jg = params_from_flax(jax.tree_util.tree_map(np.asarray, jg))
    for policy in ("full", "dots"):
        cfg = DistilBertConfig.tiny(dropout=0.0, attention_dropout=0.0,
                                    remat=True, remat_policy=policy)
        model = NwayDualEncoder(cfg)
        model.load_state_dict(params_from_flax(flax))
        logits = model(_torch(q), _torch(p), rng=DropoutRNG(0, 0, "cpu"))
        np.testing.assert_allclose(logits.detach().numpy(),
                                   np.asarray(jlogits), rtol=1e-5,
                                   atol=1e-6)
        loss, g = _loss_and_grads(model, _torch(q), _torch(p),
                                  DropoutRNG(0, 0, "cpu"))
        np.testing.assert_allclose(loss, float(jl), rtol=1e-5)
        for (name, _), grad in zip(model.named_parameters(), g):
            np.testing.assert_allclose(grad.numpy(), jg[name].numpy(),
                                       rtol=1e-4, atol=1e-6, err_msg=name)


# ------------------------------------------------------- trainer options


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


def test_trainer_remat_matches_no_remat(tmp_path):
    """``TrainConfig.remat`` with dropout 0.1 on: the reference's remat
    test, step losses to 1e-5 relative and final params within its Adam
    bound."""
    results = {}
    for remat in (False, True):
        t = Trainer(TrainConfig(**_cfg_kw(tmp_path, remat=remat,
                                          experiment_name=f"r{remat}")),
                    DistilBertConfig.tiny(attention_impl="pallas"),
                    device="cpu")
        assert t.model_config.remat is remat
        losses = []
        state = t.train(_dataset(NwayDataset, HashTokenizer),
                        step_hook=lambda s, m: losses.append(m["loss"]))
        results[remat] = (losses, state.params)
    np.testing.assert_allclose(results[True][0], results[False][0],
                               rtol=1e-5)
    lr = _cfg_kw(tmp_path)["learning_rate"]
    for k, v in results[False][1].items():
        np.testing.assert_allclose(results[True][1][k].numpy(), v.numpy(),
                                   rtol=1e-4, atol=4 * lr, err_msg=k)


# tensors whose gradient is zero in exact arithmetic (test_torch_train.py)
_ZERO_GRAD = ("attention.k_lin.bias",
              "passage_encoder.transformer.layer.1.output_layer_norm.bias")


def test_resume_of_a_jax_accumulation_run_mid_window(tmp_path):
    """A JAX run with grad_accum_steps=2 checkpoints after micro-step 3,
    inside its second window (optax.MultiSteps state: mini_step 1, a
    non-zero accumulator). The port resumes from that .msgpack and its
    step 4 closes the window: the final params equal the JAX run's."""
    kw = _cfg_kw(tmp_path, experiment_name="j", grad_accum_steps=2,
                 evaluate_steps=1)
    jcfg = JaxConfig.tiny(dropout=0.0, attention_dropout=0.0)
    jt = JaxTrainer(JaxTrainConfig(**kw), jcfg, mesh=make_mesh(1))
    init = jax.tree_util.tree_map(np.asarray,
                                  jt.init_state(4, seed=0).params)
    jl = []
    js = jt.train(_dataset(JaxDataset, JaxTokenizer),
                  init_params=jax.tree_util.tree_map(jnp.asarray, init),
                  step_hook=lambda s, m: jl.append(m["loss"]))
    ref = params_from_flax(jax.tree_util.tree_map(np.asarray, js.params))
    ckpt = os.path.join(jt.run_dir, "checkpoint_3.msgpack")
    assert os.path.exists(ckpt)
    from cldrd_tpu_torch.train import load_checkpoint

    blob = load_checkpoint(ckpt)
    assert blob["step"] == 3 and blob["accum"]["mini_step"] == 1
    assert blob["adam"]["count"] == 1
    assert any(float(v.abs().max()) > 0
               for v in blob["accum"]["acc"].values())
    kw.update(run_folder=str(tmp_path / "port"), experiment_name="t",
              resume=ckpt, evaluate_steps=100)
    tt = Trainer(TrainConfig(**kw), DistilBertConfig.tiny(
        dropout=0.0, attention_dropout=0.0), device="cpu")
    tl = []
    ts = tt.train(_dataset(NwayDataset, HashTokenizer),
                  step_hook=lambda s, m: tl.append(m["loss"]))
    assert ts.step == 4 and len(tl) == 1
    np.testing.assert_allclose(tl, jl[3:], rtol=1e-4)
    assert tt.optimizer.mini_step == 0   # the window closed and applied
    diff = sum(float(np.sum((ts.params[k].numpy() - v.numpy()) ** 2))
               for k, v in ref.items())
    norm = sum(float(np.sum(v.numpy() ** 2)) for v in ref.values())
    assert np.sqrt(diff / norm) < 1e-4
    for k, v in ref.items():
        atol = kw["learning_rate"] * (2 if k.endswith(_ZERO_GRAD) else 0.1)
        np.testing.assert_allclose(ts.params[k].numpy(), v.numpy(),
                                   rtol=1e-4, atol=atol, err_msg=k)
