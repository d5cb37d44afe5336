"""The SASS check for wgmma register hazards (cldrd_tpu_torch/ops/
_wgmma_check.py) on listings written in cuobjdump's form: it must find a
register-A operand or an accumulator used before the wait that retires
its product, along straight code and across a loop's back edge, and
nothing in code that waits first."""
import pytest

from cldrd_tpu_torch.ops import _wgmma_check as wc


def _listing(*lines):
    body = "\n".join(
        f"        /*{16 * i:04x}*/                   {ln} ;"
        f"                  /* 0x000000000000000000 */"
        for i, ln in enumerate(lines))
    return ("\n\tcode for sm_90a\n\t\tFunction : _Z6kernelv\n"
            f"\t.headerflags\t@\"EF_CUDA_SM90\"\n{body}\n")


# one product a chunk, its A fragment loaded into R148..R151 (the form a
# plain copy of the loads takes when the compiler folds it), waited on
# with one group left in flight, in a loop
FOLDED = ("LDG.E.128.CONSTANT R148, desc[UR4][R2.64]",
          "WARPGROUP.ARRIVE",
          "HGMMA.64x64x16.F32.BF16 R56, R148, gdesc[UR20], R56, gsb0",
          "WARPGROUP.DEPBAR.LE gsb0, 0x1",
          "@P0 BRA 0x0",
          "WARPGROUP.DEPBAR.LE gsb0, 0x0",
          "EXIT",
          "BRA 0x70")
# two fragment sets in turn (what copy_reg gives): each set is written
# again only after the wait that retires the product reading it
ALTERNATING = ("IMAD.MOV.U32 R148, RZ, RZ, R116",
               "WARPGROUP.ARRIVE",
               "HGMMA.64x64x16.F32.BF16 R56, R148, gdesc[UR20], R56, gsb0",
               "WARPGROUP.DEPBAR.LE gsb0, 0x1",
               "IMAD.MOV.U32 R152, RZ, RZ, R117",
               "WARPGROUP.ARRIVE",
               "HGMMA.64x64x16.F32.BF16 R56, R152, gdesc[UR20], R56, gsb0",
               "WARPGROUP.DEPBAR.LE gsb0, 0x1",
               "@P0 BRA 0x0",
               "WARPGROUP.DEPBAR.LE gsb0, 0x0",
               "STS [R3], R56",
               "EXIT")


def test_parse_reads_functions_opcodes_and_operands():
    fns = wc.parse(_listing(*FOLDED))
    (name, insns), = fns.items()
    assert name == "_Z6kernelv"
    hg = insns[2]
    assert hg.op == "HGMMA.64x64x16.F32.BF16"
    assert hg.args == ["R56", "R148", "gdesc[UR20]", "R56", "gsb0"]
    assert insns[4].pred == "@P0" and insns[4].addr == 0x40
    assert wc._written(insns[0]) == {148, 149, 150, 151}
    assert wc._written(hg) == set(range(56, 88))


def test_folded_fragment_is_a_hazard_across_the_back_edge():
    hz = wc.hazards(_listing(*FOLDED))
    assert [(h.hgmma.addr, h.insn.addr, h.kind) for h in hz] == [
        (0x20, 0x0, "A written")]


def test_alternating_fragment_sets_are_safe():
    assert wc.hazards(_listing(*ALTERNATING)) == []


@pytest.mark.parametrize("depth,found", [(0, False), (1, True)])
def test_wait_depth_decides(depth, found):
    # the next load waits for no group (depth 0) or for all but one
    lines = list(FOLDED)
    lines[3] = f"WARPGROUP.DEPBAR.LE gsb0, {hex(depth)}"
    assert bool(wc.hazards(_listing(*lines))) == found


def test_accumulator_read_before_the_wait():
    lines = ("WARPGROUP.ARRIVE",
             "HGMMA.64x64x16.F32.BF16 R56, gdesc[UR4], R56, gsb0",
             "FMNMX R3, R60, R61, !PT",
             "WARPGROUP.DEPBAR.LE gsb0, 0x0",
             "FMNMX R4, R60, R61, !PT",
             "EXIT")
    hz = wc.hazards(_listing(*lines))
    assert [(h.insn.addr, h.kind) for h in hz] == [
        (0x20, "accumulator touched")]


def test_uncommitted_group_is_not_retired():
    # a wait before the group's commit does not retire it
    lines = ("WARPGROUP.ARRIVE",
             "HGMMA.64x64x16.F32.BF16 R56, R148, gdesc[UR4], R56",
             "WARPGROUP.DEPBAR.LE gsb0, 0x0",
             "MOV R148, R7",
             "HGMMA.64x64x16.F32.BF16 R56, R152, gdesc[UR4], R56, gsb0",
             "WARPGROUP.DEPBAR.LE gsb0, 0x0",
             "MOV R149, R7",
             "EXIT")
    hz = wc.hazards(_listing(*lines))
    assert [(h.hgmma.addr, h.insn.addr) for h in hz] == [(0x10, 0x30)]
