"""The copied arithmetic reproduces the bounds of PERF.md's kernel table
at the table's shapes, and the FLOP counts agree with one another."""
import pytest

from portbench import roofline as R


def test_peaks_are_the_data_sheet_s():
    assert R.PEAK_OPS["bf16"] == 989e12
    assert R.PEAK_OPS["int8"] == 1979e12
    assert R.PEAK_BYTES == 3.35e12


def test_k1_bound_at_the_search_shape():
    n, bz, k = 8_847_360, 512, 1000
    r2 = R.super_rounds(n, n // 2048, bz, k)
    assert r2 == 8  # R2=8 in the table's row
    ms, kind = R.bound_ms(*R.k1_bytes_ops(bz, n, 768, "int8", "bf16", r2,
                                          True), "bf16")
    assert round(ms, 3) == 7.035 and kind == "operations"


def test_k1_bound_at_the_bf16_shape():
    n, bz = 1_048_576, 512
    r2 = R.super_rounds(n, n // 2048, bz, 1000)
    assert r2 == 16
    ms, kind = R.bound_ms(*R.k1_bytes_ops(bz, n, 768, "bf16", "bf16", r2,
                                          False), "bf16")
    assert round(ms, 3) == 0.834 and kind == "operations"


@pytest.mark.parametrize("tensors,dots,want", [(4, 2, 0.113), (7, 5, 0.197)])
def test_k3_k4_bounds_at_the_passage_shape(tensors, dots, want):
    ms, kind = R.bound_ms(*R.attn_bytes_ops(240, 256, "bf16", tensors, dots),
                          "bf16")
    assert round(ms, 3) == want and kind == "bytes"


def test_k5_d32_bound_at_the_teacher_shape():
    """B=128, L=256, 12 heads of 32; the table's row drew 39-90 real tokens
    a pair, and 62 a row reproduce its 0.0187 ms."""
    ms, kind = R.bound_ms(*R.attn_bytes_ops(128, 256, "bf16", 4, 2,
                                            heads=12, head_dim=32,
                                            keys=128 * 62), "bf16")
    assert round(ms, 4) == 0.0187 and kind == "bytes"


def test_dense_step_flops_match_the_encoder_sum():
    dense = R.train_step_flops_dense(768, 3072, 6, 8, 30, 30, 256)
    split = 3 * (R.encoder_fwd_flops(8, 30, 768, 3072, 6, cls_only=False)
                 + R.encoder_fwd_flops(240, 256, 768, 3072, 6,
                                       cls_only=False))
    assert dense == pytest.approx(split, rel=1e-12)
    # the CLS-only last block saves most of a sixth of the step
    cls = 3 * (R.encoder_fwd_flops(8, 30, 768, 3072, 6)
               + R.encoder_fwd_flops(240, 256, 768, 3072, 6))
    assert 0.8 * dense < cls < 0.9 * dense


def test_seq_flops_at_full_length_equal_the_encoder_count():
    assert R.seq_fwd_flops([256] * 3, 384, 1536, 6) == pytest.approx(
        R.encoder_fwd_flops(3, 256, 384, 1536, 6))


def test_kernel_classes():
    assert R.kernel_class("attn_fwd_sm90_kernel") == \
        "attention forward (K3/K5)"
    assert R.kernel_class("attn_bwd_sm90_kernel") == \
        "attention backward (K4)"
    assert R.kernel_class("sm90_xmma_gemm_bf16bf16") == "matmul (cuBLAS)"
    assert R.kernel_class("void at::native::vectorized_elementwise_kernel"
                          ) == R.ELEMENTWISE


def test_pct_reads_nothing_from_nothing():
    assert R.pct(1.0, 0.0) is None
    assert R.pct(1.0, 4.0) == 25.0
