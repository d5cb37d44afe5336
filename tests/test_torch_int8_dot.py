"""K7 (cldrd_tpu_torch/ops/int8_dot.py) held to the TPU kernel it ports,
``examples/bench_int8_dot.py::make_kernel``, on the CPU.

The JAX side runs ``make_kernel(mode)`` in Pallas interpret mode with the
grid and BlockSpecs of the script's ``bench`` (one grid step a store tile,
all the queries resident, one ``[1, B]`` row of maxima out), at a small
size; the script is loaded from its file and not edited. The port's
``tile_max_scores`` runs its plain version on CPU tensors. Integer-valued
inputs in [-127, 127] make every product and sum exact in both frameworks
(|sum| <= 127 * 127 * 128 < 2^24), so the maxima must be EQUAL in every
mode; on normal bf16 data only the fp32 summation order differs, within
1e-5 relative.
"""
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from cldrd_tpu_torch.ops import int8_dot as k7

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N, T, B = 512, 128, 16
MODES = {  # mode: (JAX query dtype, JAX store dtype, torch query, store)
    "bf16": (jnp.bfloat16, jnp.bfloat16, torch.bfloat16, torch.bfloat16),
    "int8_cast": (jnp.bfloat16, jnp.int8, torch.bfloat16, torch.int8),
    "int8_native": (jnp.int8, jnp.int8, torch.int8, torch.int8),
}


def _bench_module():
    spec = importlib.util.spec_from_file_location(
        "bench_int8_dot", os.path.join(ROOT, "examples", "bench_int8_dot.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _jax_tile_max(mode, q, c, tile_rows):
    """The TPU kernel in interpret mode, gridded as bench() grids it."""
    n, d = c.shape
    bz = q.shape[0]
    qd, cd, _, _ = MODES[mode]
    fn = pl.pallas_call(
        _bench_module().make_kernel(mode),
        grid=(n // tile_rows,),
        in_specs=[pl.BlockSpec((bz, d), lambda i: (0, 0)),
                  pl.BlockSpec((tile_rows, d), lambda i: (i, 0))],
        out_specs=pl.BlockSpec((1, bz), lambda i: (i, 0)),
        out_shape=jax.ShapeDtypeStruct((n // tile_rows, bz), jnp.float32),
        interpret=True)
    return np.asarray(fn(jnp.asarray(q, qd), jnp.asarray(c, cd)))


def _inputs(mode, d, integer, seed):
    """fp32 numpy operands: integers in [-127, 127], or a normal draw for
    the bf16 operands (int8 codes stay integers), rounded to bf16."""
    rng = np.random.default_rng(seed)
    _, _, tq, tc = MODES[mode]

    def draw(shape, dtype):
        if integer or dtype == torch.int8:
            return rng.integers(-127, 128, shape).astype(np.float32)
        x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
        return x.to(torch.bfloat16).float().numpy()

    return draw((B, d), tq), draw((N, d), tc)


# every mode on integer inputs; the modes with a bf16 operand also on a
# normal draw (int8 x int8 has integer operands only)
@pytest.mark.parametrize("mode,d,integer", [
    (mode, d, integer) for mode in MODES for d in (64, 128)
    for integer in (True, False) if integer or mode != "int8_native"])
def test_tile_max_scores_matches_the_pallas_kernel(mode, d, integer):
    q, c = _inputs(mode, d, integer, seed=d + 10 * integer)
    _, _, tq, tc = MODES[mode]
    got = k7.tile_max_scores(torch.from_numpy(q).to(tq),
                             torch.from_numpy(c).to(tc), T).numpy()
    ref = _jax_tile_max(mode, q, c, T)
    assert got.shape == ref.shape == (N // T, B) and got.dtype == np.float32
    exact = (q.astype(np.float64) @ c.astype(np.float64).T).T.reshape(
        N // T, T, B).max(1)
    if integer:
        assert np.array_equal(got, ref)
        assert np.array_equal(got, exact)
    else:
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=0)
        np.testing.assert_allclose(got, exact, rtol=1e-5, atol=0)


@pytest.mark.parametrize("tile_rows,chunk", [(128, 256), (256, 256),
                                             (512, 256), (128, 100)])
def test_plain_version_chunks_at_tile_edges(tile_rows, chunk, monkeypatch):
    """Chunks of whole tiles (one tile when a tile is larger than the
    chunk bound) give the one-chunk result."""
    q, c = _inputs("int8_native", 128, True, seed=3)
    qt, ct = torch.from_numpy(q).to(torch.int8), torch.from_numpy(c).to(
        torch.int8)
    whole = k7.tile_max_scores_plain(qt, ct, tile_rows)
    monkeypatch.setattr(k7, "_PLAIN_CHUNK_ROWS", chunk)
    assert torch.equal(k7.tile_max_scores_plain(qt, ct, tile_rows), whole)


@pytest.mark.parametrize("q_dtype,c_dtype,route", [
    (torch.bfloat16, torch.bfloat16, "bf16"),
    (torch.bfloat16, torch.int8, "int8_cast"),
    (torch.int8, torch.int8, "int8_native"),
    (torch.int8, torch.bfloat16, None),
    (torch.float32, torch.float32, None),
    (torch.bfloat16, torch.float32, None),
    (torch.float16, torch.int8, None),
])
def test_kernel_route_by_dtype_alone(q_dtype, c_dtype, route):
    if route is None:
        with pytest.raises(TypeError):
            k7.kernel_route(q_dtype, c_dtype)
    else:
        assert k7.kernel_route(q_dtype, c_dtype) == route
        assert route in k7.KERNEL_NAMES


def _ok_operands(bz=128, n=1024, d=768, q_dtype=torch.bfloat16,
                 c_dtype=torch.int8):
    return (torch.zeros(bz, d, dtype=q_dtype),
            torch.zeros(n, d, dtype=c_dtype))


@pytest.mark.parametrize("case,error", [
    ("fp32 store", TypeError), ("int8 queries, bf16 store", TypeError),
    ("B=100", ValueError), ("B=0", ValueError), ("D=96", ValueError),
    ("D=832", ValueError), ("D=736", ValueError), ("dims differ", ValueError),
    ("tile 100", ValueError), ("tile 384 of 1024", ValueError),
    ("tile 0", ValueError), ("strided corpus", ValueError),
    ("3-D queries", ValueError), ("ok", None), ("ok native D=192", None),
])
def test_check_operands_refuses_what_the_kernel_does_not_take(case, error):
    """What a CUDA tensor is checked for before the kernel launches (the
    same checks run here on CPU tensors)."""
    q, c = _ok_operands()
    tile = 256
    if case == "fp32 store":
        c = c.float()
    elif case == "int8 queries, bf16 store":
        q, c = q.to(torch.int8), c.to(torch.bfloat16)
    elif case.startswith("B="):
        q = q[:int(case[2:])].contiguous()
    elif case.startswith("D="):
        d = int(case[2:])
        q, c = _ok_operands(d=d)
    elif case == "dims differ":
        c = c[:, :640].contiguous()
    elif case.startswith("tile"):
        tile = int(case.split()[1])
    elif case == "strided corpus":
        c = torch.zeros(1024, 1536, dtype=torch.int8)[:, ::2]
    elif case == "3-D queries":
        q = q[None]
    elif case == "ok native D=192":
        q, c = _ok_operands(d=192, q_dtype=torch.int8)
    if error is None:
        k7.check_operands(q, c, tile)
    else:
        with pytest.raises(error):
            k7.check_operands(q, c, tile)


def test_wrapper_routes_by_device():
    """A CPU tensor takes the plain version and launches nothing; any other
    non-CUDA device raises."""
    q, c = _inputs("int8_cast", 128, True, seed=5)
    qt = torch.from_numpy(q).to(torch.bfloat16)
    ct = torch.from_numpy(c).to(torch.int8)
    before = (k7.LAUNCHES, dict(k7.ENTRY_LAUNCHES))
    assert torch.equal(k7.tile_max_scores(qt, ct, T),
                       k7.tile_max_scores_plain(qt, ct, T))
    assert (k7.LAUNCHES, k7.ENTRY_LAUNCHES) == before
    with pytest.raises(ValueError):
        k7.tile_max_scores(qt.to("meta"), ct.to("meta"), T)
