"""cldrd_tpu_torch.models against the flax encoder on the same weights."""
import argparse

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cldrd_tpu.models import DistilBertConfig as JaxConfig
from cldrd_tpu.models import NwayDualEncoder as JaxDualEncoder
from cldrd_tpu.models.hf_loader import dual_encoder_flax_to_torch
from cldrd_tpu_torch.models import DistilBertConfig, NwayDualEncoder
from cldrd_tpu_torch.models.convert import (
    dual_encoder_state_dict,
    load_checkpoint,
    params_from_flax,
)


def _flax_params(share_weights, seed=0):
    cfg = JaxConfig.tiny()
    model = JaxDualEncoder(config=cfg, share_weights=share_weights)
    dq = {"input_ids": jnp.zeros((1, 8), jnp.int32),
          "attention_mask": jnp.ones((1, 8), jnp.int32)}
    dp = {"input_ids": jnp.zeros((1, 1, 8), jnp.int32),
          "attention_mask": jnp.ones((1, 1, 8), jnp.int32)}
    params = model.init(jax.random.PRNGKey(seed), dq, dp)["params"]
    return jax.tree_util.tree_map(np.asarray, params)


def _tokens(rng, bz, length, vocab=512):
    ids = rng.integers(3, vocab, (bz, length)).astype(np.int32)
    lens = rng.integers(2, length + 1, bz)
    mask = (np.arange(length)[None, :] < lens[:, None]).astype(np.int32)
    ids[:, 0] = 1
    return {"input_ids": ids * mask, "attention_mask": mask}


def _embs(params, tokens, share_weights, cosine, jax_dtype, torch_dtype):
    jm = JaxDualEncoder(config=JaxConfig.tiny(), share_weights=share_weights,
                        apply_cosine_similarity=cosine, dtype=jax_dtype)
    tm = NwayDualEncoder(DistilBertConfig.tiny(), share_weights=share_weights,
                         apply_cosine_similarity=cosine, dtype=torch_dtype)
    tm.load_state_dict(params_from_flax(params))
    tm.eval()
    jt = {k: jnp.asarray(v) for k, v in tokens.items()}
    tt = {k: torch.from_numpy(v).long() for k, v in tokens.items()}
    out = []
    for method in ("query_embs", "passage_embs"):
        j = jm.apply({"params": params}, jt, method=getattr(jm, method))
        with torch.no_grad():
            t = getattr(tm, method)(tt)
        out.append((np.asarray(j.astype(jnp.float32)), t.float().numpy()))
    return out


@pytest.mark.parametrize("share_weights,cosine", [(False, False),
                                                  (True, True)])
def test_fp32_embeddings_match_flax(share_weights, cosine):
    params = _flax_params(share_weights)
    tokens = _tokens(np.random.default_rng(0), 6, 24)
    for j, t in _embs(params, tokens, share_weights, cosine, jnp.float32,
                      torch.float32):
        np.testing.assert_allclose(t, j, rtol=1e-5, atol=2e-5)


def test_bf16_embeddings_match_flax():
    """bf16 rounds at other places in the two frameworks: 2e-2 relative in
    L2 norm per embedding."""
    params = _flax_params(False, seed=1)
    tokens = _tokens(np.random.default_rng(1), 6, 24)
    for j, t in _embs(params, tokens, False, False, jnp.bfloat16,
                      torch.bfloat16):
        rel = np.linalg.norm(t - j, axis=1) / np.linalg.norm(j, axis=1)
        assert rel.max() < 2e-2, rel


def test_params_from_flax_equals_hf_loader_export():
    for share in (False, True):
        params = _flax_params(share)
        ours = params_from_flax(params)
        ref = dual_encoder_flax_to_torch(params, share_weights=share)
        assert set(ours) == set(ref)
        for k, v in ref.items():
            np.testing.assert_array_equal(ours[k].numpy(), v)
        # and it is exactly the port's own state_dict layout
        model = NwayDualEncoder(DistilBertConfig.tiny(), share_weights=share)
        assert set(model.state_dict()) == set(ours)


def test_pth_tar_roundtrip(tmp_path):
    """A reference-layout checkpoint (``module.`` prefix, state_dict
    wrapper, pickled args) loads into the port and encodes identically."""
    params = _flax_params(False, seed=2)
    sd = {f"module.{k}": torch.from_numpy(np.array(v))
          for k, v in dual_encoder_flax_to_torch(params).items()}
    path = str(tmp_path / "checkpoint_7.pth.tar")
    torch.save({"state_dict": sd, "args": argparse.Namespace(lr=1e-5),
                "step": 7}, path)
    model = NwayDualEncoder(DistilBertConfig.tiny())
    model.load_state_dict(dual_encoder_state_dict(load_checkpoint(path)))
    model.eval()
    direct = NwayDualEncoder(DistilBertConfig.tiny())
    direct.load_state_dict(params_from_flax(params))
    direct.eval()
    tokens = {k: torch.from_numpy(v).long()
              for k, v in _tokens(np.random.default_rng(2), 3, 16).items()}
    with torch.no_grad():
        assert torch.equal(model.query_embs(tokens), direct.query_embs(tokens))
    # a flax .msgpack of the same weights (a JAX Trainer checkpoint's
    # layout) encodes identically too
    from flax import serialization

    blob = serialization.msgpack_serialize(
        {"params": params, "opt_state": {}, "step": np.int32(7)})
    (tmp_path / "x.msgpack").write_bytes(blob)
    from_msgpack = NwayDualEncoder(DistilBertConfig.tiny())
    from_msgpack.load_state_dict(dual_encoder_state_dict(
        load_checkpoint(str(tmp_path / "x.msgpack"))))
    from_msgpack.eval()
    with torch.no_grad():
        assert torch.equal(from_msgpack.query_embs(tokens),
                           direct.query_embs(tokens))


def test_position_table_length_is_checked():
    model = NwayDualEncoder(DistilBertConfig.tiny())
    ids = torch.ones((1, 65), dtype=torch.long)
    with pytest.raises(ValueError, match="max_position_embeddings"):
        model.query_embs({"input_ids": ids, "attention_mask": ids})


def test_random_init_is_seeded_and_shaped_like_the_reference():
    a = NwayDualEncoder(DistilBertConfig.tiny()).reset_parameters(seed=3)
    b = NwayDualEncoder(DistilBertConfig.tiny()).reset_parameters(seed=3)
    for (k, v), (_, w) in zip(a.state_dict().items(), b.state_dict().items()):
        assert torch.equal(v, w), k
    w = a.state_dict()["query_encoder.transformer.layer.0.ffn.lin1.weight"]
    assert abs(w.std().item() - 0.02) < 0.004
    assert not torch.equal(
        w, a.state_dict()["passage_encoder.transformer.layer.0.ffn.lin1.weight"])
