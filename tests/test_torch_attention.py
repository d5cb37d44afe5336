"""cldrd_tpu_torch.ops.attention (K3/K4/K5 plain versions on the CPU) and
the encoder's attention routes, held to cldrd_tpu.ops.attention on the
same numpy-seeded inputs. The JAX kernels run in Pallas interpret mode on
the CPU, as tests/test_ops.py runs them.

Tolerances: the dropout mask is bit-identical (EQUAL); fp32 outputs and
gradients agree within 1e-5 of the largest magnitude (both sides
accumulate in fp32, in different orders), and gradients through a whole
encoder within 1e-4; bf16 within 2e-2, one bf16 ulp of a probability
near 1 being 2**-8."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cldrd_tpu.models import DistilBertConfig as JaxConfig
from cldrd_tpu.models import DistilBertEncoder as JaxEncoder
from cldrd_tpu.ops import attention as ja
from cldrd_tpu_torch.models import DistilBertConfig, DropoutRNG
from cldrd_tpu_torch.models.convert import tower_from_flax
from cldrd_tpu_torch.models.distilbert import (
    DistilBertEncoder,
    resolve_attention_impl,
)
from cldrd_tpu_torch.ops import attention as ta


def _close(got, ref, rtol):
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    scale = max(np.abs(ref).max(), 1e-30)
    assert np.abs(got - ref).max() <= rtol * scale, (
        np.abs(got - ref).max(), scale)


@pytest.mark.parametrize("seed", [0, 12345, -7, 2**31 - 1, -2**31])
def test_hash_keep_is_bit_identical(seed):
    """Indices past 2**31 wrap as int32 does."""
    idx = np.concatenate([np.arange(4096, dtype=np.int64),
                          [2**31 - 1, 2**31, 2**32 - 1, 2**32 + 5,
                           3 * 2**31 + 7, 240 * 12 * 256 * 256 - 1]])
    ref = np.asarray(ja._hash_keep(
        jnp.asarray(idx.astype(np.uint32).view(np.int32)), jnp.int32(seed),
        0.1))
    got = ta.hash_keep(torch.from_numpy(idx), seed, 0.1).numpy()
    np.testing.assert_array_equal(got, ref)


def test_dropout_keep_mask_equals_reference_and_is_calibrated():
    for p in (0.1, 0.25):
        ref = np.asarray(ja.dropout_keep_mask(3, 5, 17, 19, jnp.int32(99), p))
        got = ta.dropout_keep_mask(3, 5, 17, 19, 99, p).numpy()
        np.testing.assert_array_equal(got, ref)
    keep = ta.dropout_keep_mask(8, 12, 64, 64, 3, 0.1).numpy()
    assert abs(keep.mean() - 0.9) < 0.01


def _qkvg(rng, bsz=2, seq=32, heads=4, dim=8, segments=False):
    q, k, v, g = (rng.standard_normal((bsz, seq, heads, dim)).astype(
        np.float32) for _ in range(4))
    seg = None
    mask = np.ones((bsz, seq), np.int32)
    mask[0, seq // 2:] = 0
    if segments:
        seg = np.zeros((bsz, seq), np.int32)
        seg[:, :seq // 3] = 1
        seg[:, seq // 3:seq - 4] = 2
        mask = (seg > 0).astype(np.int32)
    return q, k, v, g, mask, seg


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("p,segments", [(0.0, False), (0.2, False),
                                        (0.2, True)])
def test_train_attention_matches_pallas_kernels(p, segments, dtype):
    """Output and dq/dk/dv of flash_attention_train (K3/K4 plain versions)
    against the reference's kernels, same seed."""
    q, k, v, g, mask, seg = _qkvg(np.random.default_rng(1), segments=segments)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jseg = None if seg is None else jnp.asarray(seg)
    jq, jk, jv, jg = (jnp.asarray(x, jdt) for x in (q, k, v, g))
    out, vjp = jax.vjp(lambda a, b, c: ja.flash_attention_train(
        a, b, c, jnp.asarray(mask), jnp.int32(99), p, jseg), jq, jk, jv)
    jgrads = vjp(jg)
    tq, tk, tv = (torch.from_numpy(x).to(tdt).requires_grad_()
                  for x in (q, k, v))
    tout = ta.flash_attention_train(
        tq, tk, tv, torch.from_numpy(mask), 99, p,
        None if seg is None else torch.from_numpy(seg))
    tout.backward(torch.from_numpy(g).to(tdt))
    rtol = 1e-5 if dtype == "float32" else 2e-2
    _close(tout.detach().float(), out.astype(jnp.float32), rtol)
    for t, j in zip((tq, tk, tv), jgrads):
        _close(t.grad.float(), j.astype(jnp.float32), rtol)


def test_infer_attention_matches_pallas_kernel_and_its_backward():
    """K5's plain version against the reference kernel; the backward
    recomputes through xla_attention, as the reference's does."""
    q, k, v, g, mask, _ = _qkvg(np.random.default_rng(2), seq=24)
    out, vjp = jax.vjp(lambda a, b, c: ja.flash_attention(
        a, b, c, jnp.asarray(mask)), *(jnp.asarray(x) for x in (q, k, v)))
    jgrads = vjp(jnp.asarray(g))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    tout = ta.flash_attention(tq, tk, tv, torch.from_numpy(mask))
    tout.backward(torch.from_numpy(g))
    _close(tout.detach(), out, 1e-5)
    for t, j in zip((tq, tk, tv), jgrads):
        _close(t.grad, j, 1e-5)
    assert ta.LAUNCHES == {"train_fwd": 0, "train_bwd": 0, "infer": 0}


def _encoders(impl, **cfg_kw):
    jcfg = JaxConfig.tiny(attention_impl=impl, **cfg_kw)
    jm = JaxEncoder(jcfg)
    ids = jnp.ones((1, 8), jnp.int32)
    params = jm.init(jax.random.PRNGKey(0), ids, ids)["params"]
    params = jax.tree_util.tree_map(np.asarray, params)
    tm = DistilBertEncoder(DistilBertConfig.tiny(attention_impl=impl,
                                                 **cfg_kw))
    tm.load_state_dict(tower_from_flax(params))
    return jm, params, tm


def _tokens(rng, bz=3, length=20):
    ids = rng.integers(3, 512, (bz, length)).astype(np.int32)
    lens = rng.integers(4, length + 1, bz)
    mask = (np.arange(length)[None] < lens[:, None]).astype(np.int32)
    return ids * mask, mask


@pytest.mark.parametrize("cls_only", [False, True])
def test_encoder_pallas_route_matches_reference(cls_only):
    """attention_impl='pallas' in eval mode (K5, einsum for a cls_only
    final block): hidden states, and the gradient of a fixed random
    projection of them with respect to the embeddings (through K5's
    recompute backward)."""
    jm, params, tm = _encoders("pallas")
    rng = np.random.default_rng(3)
    ids, mask = _tokens(rng)
    w = rng.standard_normal((3, 1 if cls_only else 20, 32)).astype(
        np.float32)

    def jloss(p):
        h = jm.apply({"params": p}, jnp.asarray(ids), jnp.asarray(mask),
                     cls_only=cls_only)
        return jnp.sum(h * w), h

    (_, jh), jgrad = jax.value_and_grad(jloss, has_aux=True)(params)
    th = tm(torch.from_numpy(ids).long(), torch.from_numpy(mask),
            cls_only=cls_only)
    (th * torch.from_numpy(w)).sum().backward()
    _close(th.detach(), jh, 1e-5)
    _close(tm.embeddings.word_embeddings.weight.grad,
           jgrad["embeddings"]["word_embeddings"]["embedding"], 1e-4)


def test_encoder_packed_rows_match_reference():
    """Position reset and segment masking in the einsum route (the
    reference takes it for packed rows outside training), fp32."""
    jm, params, tm = _encoders("xla")
    rng = np.random.default_rng(4)
    ids, _ = _tokens(rng, bz=2, length=24)
    seg = np.zeros((2, 24), np.int32)
    seg[:, :9], seg[:, 9:20] = 1, 2
    mask = (seg > 0).astype(np.int32)
    pos = np.where(seg == 2, np.arange(24) - 9, np.arange(24)) * mask
    jh = jm.apply({"params": params}, jnp.asarray(ids), jnp.asarray(mask),
                  position_ids=jnp.asarray(pos), segment_ids=jnp.asarray(seg))
    th = tm(torch.from_numpy(ids).long(), torch.from_numpy(mask),
            position_ids=torch.from_numpy(pos).long(),
            segment_ids=torch.from_numpy(seg))
    real = mask.astype(bool)
    _close(th.detach().numpy()[real], np.asarray(jh)[real], 1e-5)


def test_train_mode_routes_through_the_train_kernels_plain_version():
    """Training with attention dropout and attention_impl='pallas' takes
    flash_attention_train with a seed from the step's DropoutRNG: the
    same (seed, step) replays the same output, another step differs."""
    _, _, tm = _encoders("pallas", dropout=0.0, attention_dropout=0.2)
    ids, mask = _tokens(np.random.default_rng(5))
    run = lambda step: tm(torch.from_numpy(ids).long(),  # noqa: E731
                          torch.from_numpy(mask),
                          rng=DropoutRNG(7, step, "cpu")).detach()
    assert torch.equal(run(3), run(3))
    assert not torch.equal(run(3), run(4))


def test_resolve_attention_impl():
    cpu, cuda = torch.device("cpu"), torch.device("cuda")
    assert resolve_attention_impl("auto", True, cuda) == "pallas"
    assert resolve_attention_impl("auto", False, cuda) == "xla"
    assert resolve_attention_impl("auto", True, cpu) == "xla"
    assert resolve_attention_impl("pallas", False, cpu) == "pallas"
    with pytest.raises(ValueError):
        resolve_attention_impl("flash", True, cpu)


def test_wrappers_route_by_device():
    """CPU tensors take the plain versions; a device with no route
    raises (CUDA tensors launch the kernels: tests/test_torch_kernels_cuda.py)."""
    q = torch.zeros((1, 4, 2, 32), device="meta")
    mask = torch.ones((1, 4), device="meta")
    with pytest.raises(ValueError, match="no route"):
        ta.flash_attention(q, q, q, mask)
    with pytest.raises(ValueError, match="no route"):
        ta.flash_attention_train(q, q, q, mask, 0, 0.1)
