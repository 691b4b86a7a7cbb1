"""kissabc_tpu_torch/ops/sass.py: the reader of ``cuobjdump -sass``
listings that counts the instructions per draw of the kernels' draw
loops (tools/sass_draw_loop.py), on a listing written by hand in
cuobjdump's format."""

import pytest

from kissabc_tpu_torch.ops import sass
from torch_threads import one_torch_thread  # noqa: F401

LISTING = """
        code for sm_90a
                Function : _Z6kernelPf
        .headerflags    @"EF_CUDA_SM90"
        /*0000*/                   MOV R1, c[0x0][0x28] ;   /* 0xa0000017a02 */
                                                     /* 0x000fe40000000f00 */
        /*0010*/                   IMAD.WIDE.U32 R2, R4, -0x2daee0ad, RZ ;
        /*0020*/                   FRND.FLOOR R0, R2 ;
        /*0030*/                   FADD R3, R0, 1 ;
        /*0040*/                   FRND.FLOOR R5, R3 ;
        /*0050*/              @!P0 BRA 0x10 ;
        /*0060*/                   IMAD R6, R6, 0x2c1b3c6d, RZ ;
        /*0070*/                   FRND.FLOOR R0, R6 ;
        /*0080*/               @P1 BRA 0x60 ;
        /*0090*/                   IADD3 R7, R7, 0x1, RZ ;
        /*00a0*/               @P2 BRA 0x0 ;
        /*00b0*/                   BRA 0xc0 ;
        /*00c0*/                   EXIT ;
                ..........
                Function : _Z5otherv
        /*0000*/                   IADD3 R1, R1, 0x1, RZ ;
        /*0010*/               @P0 BRA 0x0 ;
        /*0020*/                   EXIT ;
"""


def test_functions_split_the_listing():
    fns = sass.functions(LISTING)
    assert list(fns) == ["_Z6kernelPf", "_Z5otherv"]
    assert len(fns["_Z6kernelPf"]) == 13 and len(fns["_Z5otherv"]) == 3
    assert fns["_Z6kernelPf"][5] == (0x50, "@!P0 BRA 0x10")


@pytest.mark.parametrize("text, op", [
    ("@!P0 BRA 0x10", "BRA"), ("IMAD.WIDE.U32 R2, R4, -0x2daee0ad, RZ",
                               "IMAD.WIDE.U32"),
    ("@P1 FADD R22, R16, R22", "FADD"), ("", "")])
def test_opcode_drops_the_predicate(text, op):
    assert sass.opcode(text) == op


def test_loops_are_backward_branches():
    instrs = sass.functions(LISTING)["_Z6kernelPf"]
    assert sorted(sass.loops(instrs)) == [(0, 10), (1, 5), (6, 8)]
    assert sass.loops(sass.functions(LISTING)["_Z5otherv"]) == [(0, 1)]


def test_draw_loops_are_the_innermost_with_angles():
    """The outer loop (0x0-0xa0) holds both draw loops and is not one;
    the loop without FRND.FLOOR is none either."""
    found = sass.draw_loops(sass.functions(LISTING)["_Z6kernelPf"])
    assert [(d["start"], d["end"]) for d in found] == [("0x10", "0x50"),
                                                       ("0x60", "0x80")]
    philox, stub = found
    assert (philox["instructions"], philox["angles"]) == (5, 2)
    assert philox["per_draw"] == 5 / 4 and not philox["stub"]
    assert stub["per_draw"] == 3 / 2 and stub["stub"]
    assert philox["top"]["FRND.FLOOR"] == 2
    assert (philox["shuffles"], philox["shared"], philox["syncs"]) == (0, 0,
                                                                       0)
    assert sass.draw_loops(sass.functions(LISTING)["_Z5otherv"]) == []


def test_draw_loops_count_shuffles_shared_memory_and_barriers():
    listing = """
                Function : _Z5groupv
        /*0000*/                   FRND.FLOOR R0, R2 ;
        /*0010*/                   STS.64 [R3], R4 ;
        /*0020*/                   WARPSYNC R7 ;
        /*0030*/                   LDS.64 R8, [R9] ;
        /*0040*/                   SHFL.BFLY PT, R10, R11, 0x1, 0x1f ;
        /*0050*/                   FRND.FLOOR R1, R2 ;
        /*0060*/               @P0 BRA 0x0 ;
"""
    (loop,) = sass.draw_loops(sass.functions(listing)["_Z5groupv"])
    assert (loop["shuffles"], loop["shared"], loop["syncs"]) == (1, 2, 1)
    assert loop["per_draw"] == 7 / 4


def test_issue_floor():
    # 132 SMs x 128 lanes at 1000 MHz issue 16.896e12 instructions/s
    ms = sass.issue_floor_ms(50, 1000, 1 << 20, 1000.0)
    assert ms == pytest.approx(50 * 1000 * (1 << 20) / 16.896e12 * 1e3)
    assert sass.issue_floor_ms(50, 1000, 1 << 20, 2000.0) == pytest.approx(
        ms / 2)
