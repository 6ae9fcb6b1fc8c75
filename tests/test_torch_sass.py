"""The SASS instruction counter behind chip_smoke.py's issue floors
(tools/sass.py), held to hand-written listings in
cuobjdump -sass's format: labelled and absolute branch targets, a loop
with an exit branch inside, a straight stretch whose shortest path skips a
slow-path call and a bypass exit, a loop doing two units of work an
iteration beside its one-unit remainder loop, the work around a tap
loop that may run no iteration, and an edge loop with a projection loop
inside it counted through no, one and two divisions."""

import pytest

import torch_parity  # noqa: F401  (one torch thread, as every port test)
from tools import sass

HEADER = """
Fatbin elf code:
================
arch = sm_90a
code version = [1,7]

	code for sm_90a
"""

LOOP = HEADER + """
		Function : _ZN12_GLOBAL__N_120occluded_woop_kernelEPKfS1_S1_fS1_fPKiS1_S1_iiPh
	.headerflags	@"EF_CUDA_64BIT_ADDRESS EF_CUDA_SM90 EF_CUDA_VIRTUAL_SM(EF_CUDA_SM90)"
        /*0000*/                   LDC R1, c[0x0][0x28] ;                /* 0x00000a00ff017b82 */
                                                                         /* 0x000fe20000000800 */
        /*0010*/                   S2R R0, SR_TID.X ;                    /* 0x0000000000007919 */
.L_x_0:
        /*0020*/                   LDG.E R3, desc[UR4][R4.64] ;
        /*0030*/                   STS.128 [R2], R8 ;
        /*0040*/              @P1 BRA `(.L_x_0) ;
        /*0050*/                   BAR.RED.OR.DEFER_BLOCKING 0x0, P2 ;
.L_x_1:
        /*0058*/              @P4 BRA `(.L_x_4) ;
        /*0060*/                   LDS.128 R4, [R2] ;
        /*0070*/                   FFMA R8, R4, R9, R10 ;
.L_x_4:
        /*0080*/                   FSETP.GT.AND P0, PT, R8, R11, PT ;
        /*0090*/              @P0 BRA `(.L_x_2) ;
        /*00a0*/                   FMUL R8, R8, R8 ;
        /*00b0*/                   NOP ;
        /*00c0*/                   BRA.U !UP0, `(.L_x_1) ;
.L_x_2:
        /*00d0*/                   STG.E.U8 desc[UR4][R6.64], R8 ;
        /*00e0*/                   EXIT ;
.L_x_3:
        /*00f0*/                   BRA `(.L_x_3);
        /*0100*/                   NOP;
"""

STRAIGHT = HEADER + """
		Function : _ZN12_GLOBAL__N_113atrous_kernelEPKfS1_S1_S1_S1_iiiiPf
        /*0000*/                   S2R R0, SR_TID.X ;
        /*0010*/                   BAR.SYNC.DEFER_BLOCKING 0x0 ;
        /*0020*/              @P0 EXIT ;
        /*0030*/              @P1 BRA 0x100 ;
        /*0040*/                   MUFU.EX2 R4, R4 ;
        /*0050*/                   FCHK P2, R5, R6 ;
        /*0060*/             @!P2 BRA 0x090 ;
        /*0070*/                   MOV R12, 0x90 ;
        /*0080*/                   CALL.REL.NOINC 0x140 ;
        /*0090*/                   MUFU.EX2 R7, R7 ;
        /*00a0*/                   FADD R8, R8, R7 ;
        /*00b0*/                   STG.E desc[UR4][R2.64], R8 ;
        /*00c0*/                   EXIT ;
        /*00d0*/                   NOP ;
        /*0100*/                   STG.E desc[UR4][R2.64], R9 ;
        /*0110*/                   EXIT ;
        /*0120*/                   BRA 0x120;
        /*0140*/                   MUFU.RCP R13, R6 ;
        /*0150*/                   RET.REL.NODEC R12 0x0 ;
"""


def test_functions_parse_labels_and_addresses():
    funcs = sass.functions(LOOP + STRAIGHT)
    assert len(funcs) == 2
    woop = sass.find(funcs, "occluded_woop_kernel")
    assert [i.op for i in woop[:2]] == ["LDC", "S2R"]
    back = [i for i in woop if i.text.startswith("BRA.U")][0]
    assert back.target == 0x58 and back.pred == ""
    atrous = sass.find(funcs, "atrous_kernel")
    assert atrous[3].pred == "@P1" and atrous[3].target == 0x100
    with pytest.raises(KeyError):
        sass.find(funcs, "kernel")


def test_loop_iteration_counts_the_innermost_loop_with_the_op():
    code = sass.find(sass.functions(LOOP), "woop")
    count, path = sass.loop_iteration(code, "LDS")
    # @P4 BRA (not around the load), LDS, FFMA, FSETP, @P0 BRA (falls
    # through), FMUL, NOP (free), BRA.U.
    assert count == 7
    assert [i.op for i in path] == ["BRA", "LDS.128", "FFMA", "FSETP.GT.AND",
                                    "BRA", "FMUL", "NOP", "BRA.U"]
    assert sass.loop_iteration(code, "STS")[0] == 3
    with pytest.raises(ValueError):
        sass.loop_iteration(code, "MUFU")


def test_straight_after_takes_the_short_path_through_the_counted_ops():
    code = sass.find(sass.functions(STRAIGHT), "atrous")
    count, path = sass.straight_after(code, "BAR.SYNC", "MUFU.EX2", 2)
    # BAR, @P0 EXIT, @P1 BRA (not to the bypass), EX2, FCHK, @!P2 BRA over
    # the call, EX2, FADD, STG, EXIT.
    assert count == 10
    assert "CALL.REL.NOINC" not in [i.op for i in path]
    # With the branch over the call gone, no path is left but the call's.
    no_skip = [c for c in code if c.addr != 0x60]
    with pytest.raises(ValueError):
        sass.straight_after(no_skip, "BAR.SYNC", "MUFU.EX2", 2)
    assert sass.straight_after(code, None, "MUFU.EX2", 2)[0] == 11
    # The bypass path passes no EX2: BAR, @P0 EXIT, @P1 BRA, STG, EXIT.
    assert sass.straight_after(code, "BAR.SYNC", "MUFU.EX2", 0)[0] == 5
    with pytest.raises(ValueError):
        sass.straight_after(code, "BAR.SYNC", "MUFU.EX2", 3)


UNROLLED = HEADER + """
		Function : _ZN12_GLOBAL__N_119ris_audition_kernelILb1EEEvPKfiPKxS2_
        /*0000*/                   S2R R0, SR_TID.X ;
.L_x_0:
        /*0010*/                   LDS.128 R4, [R2] ;
        /*0018*/              @P3 BRA `(.L_x_5) ;
        /*0020*/                   IMAD R5, R5, 0x108ef2d9, RZ ;
.L_x_5:
        /*0030*/                   FMUL R6, R4, R5 ;
        /*0040*/                   LDS.128 R8, [R2+0x40] ;
        /*0050*/                   IMAD R9, R9, 0x108ef2d9, RZ ;
        /*0060*/                   FMUL R10, R8, R9 ;
        /*0070*/                   FSETP.GT.AND P0, PT, R6, R10, PT ;
        /*0080*/              @P1 BRA `(.L_x_0) ;
.L_x_1:
        /*0090*/                   LDS.128 R4, [R2] ;
        /*00a0*/                   IMAD R5, R5, 0x108ef2d9, RZ ;
        /*00b0*/                   FMUL R6, R4, R5 ;
        /*00c0*/              @P2 BRA `(.L_x_1) ;
        /*00d0*/                   EXIT ;
.L_x_2:
        /*00e0*/                   BRA `(.L_x_2);
"""


def test_loop_per_unit_takes_the_loop_doing_the_most_units():
    # A loop written (or unrolled) to do two units an iteration, and its
    # one-unit remainder loop: the count is the two-unit loop's, a unit,
    # along the path through every marked instruction (not around the
    # first one by the @P3 branch).
    code = sass.find(sass.functions(UNROLLED), "ris_audition_kernelILb1E")

    def marker(ins):
        return "0x108ef2d9" in ins.text

    count, units, path = sass.loop_per_unit(code, "LDS", marker)
    assert (count, units) == (4.5, 2.0)
    assert [i.op for i in path] == ["LDS.128", "BRA", "IMAD", "FMUL",
                                    "LDS.128", "IMAD", "FMUL", "FSETP.GT.AND",
                                    "BRA"]
    # Two markers a unit: the two-unit loop does one.
    assert sass.loop_per_unit(code, "LDS", marker, per=2)[:2] == (9.0, 1.0)
    # The smallest loop holding the op is the remainder loop; loop_iteration
    # alone takes the branch around the marked instruction.
    assert sass.loop_iteration(code, "LDS")[0] == 4
    assert [i.op for i in sass._iteration(code, 1, 9, "LDS")[1]] == [
        "LDS.128", "BRA", "FMUL", "LDS.128", "IMAD", "FMUL", "FSETP.GT.AND",
        "BRA"]
    # Passing every FMUL as well changes nothing here: they are all on it.
    assert sass.loop_per_unit(code, "LDS", marker, through=lambda ins:
                              ins.op == "FMUL")[:2] == (4.5, 2.0)
    with pytest.raises(ValueError):
        sass.loop_per_unit(code, "LDS", lambda ins: ins.op == "MUFU.RCP")


TAPS = HEADER + """
		Function : _ZN12_GLOBAL__N_117di_spatial_kernelENS_13DiSpatialArgsE
        /*0000*/                   S2R R0, SR_TID.X ;
        /*0010*/              @P0 EXIT ;
        /*0020*/                   MUFU.RSQ R4, R4 ;
        /*0030*/              @P1 BRA `(.L_x_2) ;
.L_x_0:
        /*0040*/                   IMAD R5, R5, 0x108ef2d9, RZ ;
        /*0050*/              @P2 BRA `(.L_x_1) ;
        /*0060*/                   LDG.E R6, desc[UR4][R2.64] ;
        /*0070*/                   MUFU.RCP R7, R6 ;
        /*0080*/                   FMUL R8, R7, R6 ;
.L_x_1:
        /*0090*/              @P3 BRA `(.L_x_0) ;
.L_x_2:
        /*00a0*/              @P4 BRA `(.L_x_3) ;
        /*00b0*/                   MUFU.RCP R9, R8 ;
        /*00c0*/                   FCHK P5, R9, R8 ;
        /*00d0*/             @!P5 BRA `(.L_x_3) ;
        /*00e0*/                   CALL.REL.NOINC 0x120 ;
.L_x_3:
        /*00f0*/                   STG.E desc[UR4][R2.64], R9 ;
        /*0100*/                   EXIT ;
        /*0110*/                   BRA 0x110;
        /*0120*/                   MUFU.RCP R13, R6 ;
        /*0130*/                   RET.REL.NODEC R12 0x0 ;
"""


def test_around_loop_takes_the_work_outside_a_tap_loop():
    # A tap loop that may run no iteration (@P1 BRA over it), a draw a tap
    # and a target function that a skipped tap leaves out, then a resolve
    # that a lane may skip (@P4 BRA) and whose division has a slow-path
    # CALL: the MUFU of the slow path is not one that a path reaches.
    code = sass.find(sass.functions(TAPS), "di_spatial_kernel")
    tap, units, path = sass.loop_per_unit(
        code, "LDG", lambda ins: "0x108ef2d9" in ins.text, 1,
        lambda ins: ins.op.startswith("MUFU"))
    assert (tap, units) == (6.0, 1.0)
    assert (path[0].addr, path[-1].addr) == (0x40, 0x90)

    def mufu(ins):
        return ins.op.startswith("MUFU")

    count, around = sass.around_loop(code, 4, 9, mufu)
    # S2R, @P0 EXIT, RSQ, @P1 BRA, @P4 BRA, RCP, FCHK, @!P5 BRA, STG, EXIT.
    assert count == 10
    assert [i.addr for i in around] == [0x0, 0x10, 0x20, 0x30, 0xa0, 0xb0,
                                        0xc0, 0xd0, 0xf0, 0x100]
    # Passing nothing: around the resolve too.
    assert sass.around_loop(code, 4, 9)[0] == 7
    # chip_smoke.py's K5 counts are these two.
    import chip_smoke
    assert chip_smoke.di_spatial_counts(sass.functions(TAPS)) == {
        "k5_tap": 6.0, "k5_fixed": 10}


NESTED = HEADER + """
		Function : _ZN12_GLOBAL__N_126boundary_candidates_kernelILi8ELb1EEEvPKfPKhS2_iiilPiS5_PhS6_
        /*0000*/                   S2R R0, SR_TID.X ;
.L_x_0:
        /*0010*/              @P0 BRA `(.L_x_4) ;
.L_x_1:
        /*0020*/                   FADD R4, R2, -R3 ;
        /*0030*/                   FFMA R5, R4, R6, R7 ;
        /*0040*/                   FSETP.GT.AND P1, PT, R5, RZ, PT ;
        /*0050*/              @!P1 BRA `(.L_x_3) ;
        /*0060*/                   FMUL R8, R5, R9 ;
.L_x_2:
        /*0070*/                   MUFU.RCP R10, R8 ;
        /*0080*/                   FFMA R11, R10, R8, R12 ;
        /*0090*/                   FCHK P2, R11, R8 ;
        /*00a0*/             @!P2 BRA `(.L_x_5) ;
        /*00b0*/                   CALL.REL.NOINC `(.L_x_9) ;
.L_x_5:
        /*00c0*/              @P3 BRA `(.L_x_2) ;
        /*00d0*/              @!P4 BRA `(.L_x_3) ;
        /*00e0*/                   MUFU.RSQ R13, R14 ;
        /*00f0*/                   MUFU.RCP R15, R13 ;
        /*0100*/                   FMUL R16, R15, R17 ;
.L_x_3:
        /*0110*/                   IADD3 R1, R1, 0x1, RZ ;
        /*0120*/              @P5 BRA `(.L_x_1) ;
.L_x_4:
        /*0130*/                   BAR.SYNC.DEFER_BLOCKING 0x0 ;
        /*0140*/              @P6 BRA `(.L_x_0) ;
        /*0150*/                   EXIT ;
.L_x_9:
        /*0160*/                   MUFU.RCP R13, R6 ;
        /*0170*/                   RET.REL.NODEC R12 0x0 ;
"""


def test_loop_through_counts_an_outer_loop_through_inner_iterations():
    # An edge loop (the innermost loop holding the score's MUFU.RSQ) inside
    # a tile loop, with a projection loop (one division an iteration, its
    # slow-path CALL not taken) inside it.
    code = sass.find(sass.functions(NESTED), "boundary_candidates_kernel")

    def rcp(ins):
        return ins.op.startswith("MUFU.RCP")

    # No division: FADD, FFMA, FSETP, @!P1 BRA to the loop's end, IADD3,
    # @P5 BRA.
    count, path = sass.loop_through(code, "MUFU.RSQ", rcp, 0)
    assert count == 6
    assert (path[0].addr, path[-1].addr) == (0x20, 0x120)
    # One division: the projection loop once, no score (@!P4 BRA): FADD,
    # FFMA, FSETP, BRA, FMUL, RCP, FFMA, FCHK, @!P2 BRA, @P3 BRA, @!P4 BRA,
    # IADD3, @P5 BRA.
    count, path = sass.loop_through(code, "MUFU.RSQ", rcp, 1)
    assert count == 13
    assert "CALL.REL.NOINC" not in [i.op for i in path]
    # Two: the projection loop twice (15 + 4 more: RCP, FFMA, FCHK, BRA)
    # or once and the score (13 + RSQ, RCP, FMUL): the score's is shorter.
    assert sass.loop_through(code, "MUFU.RSQ", rcp, 2)[0] == 16
    # The innermost loop holding an RCP is the projection loop: RCP, FFMA,
    # FCHK, @!P2 BRA, @P3 BRA.
    assert sass.loop_through(code, "MUFU.RCP", rcp, 1)[0] == 5
    with pytest.raises(ValueError):
        sass.loop_through(code, "MUFU.RCP", rcp, 0)


PTXAS = """ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN40_GLOBAL__N__a1fa5254_8_trace_cu_c8aeb13f14closest_kernelILi4EEEvPKfS2_S2_fS2_fS2_S2_S2_iiPfPiS3_S3_Ph' for 'sm_90a'
ptxas info    : Function properties for _ZN40_GLOBAL__N__a1fa5254_8_trace_cu_c8aeb13f14closest_kernelILi4EEEvPKfS2_S2_fS2_fS2_S2_S2_iiPfPiS3_S3_Ph
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 64 registers, used 1 barriers, 6144 bytes smem, 464 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN41_GLOBAL__N__55cd0da2_9_restir_cu_ca1cee9717di_spatial_kernelENS_13DiSpatialArgsE' for 'sm_90a'
ptxas info    : Function properties for _ZN41_GLOBAL__N__55cd0da2_9_restir_cu_ca1cee9717di_spatial_kernelENS_13DiSpatialArgsE
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 79 registers, used 0 barriers, 720 bytes cmem[0]
"""


def test_ptxas_registers_and_resident_warps():
    # chip_smoke.py's register report: nvcc names an anonymous namespace
    # after its source, and the kernel's own name follows its length.
    import chip_smoke
    regs = chip_smoke.ptxas_registers(PTXAS)
    assert regs == {"closest_kernelILi4EE": 64, "di_spatial_kernel": 79}
    # 64K registers an SM, 256 a warp at a time, at most 64 warps and 32
    # blocks: 79 registers on blocks of 256 leave 3 blocks, 24 warps.
    assert chip_smoke.resident_warps(79, 256) == 24
    assert chip_smoke.resident_warps(64, 256) == 32
    assert chip_smoke.resident_warps(64, 128) == 32
    assert chip_smoke.resident_warps(24, 128) == 64
    assert chip_smoke.kernel_registers(regs, "closest_kernel", 128) == {
        "closest_kernelILi4EE": (64, 32)}


def test_issue_floor():
    # 4 warp instructions an SM a cycle: 132 SMs at 1980 MHz issue
    # 1,045,440 a microsecond.
    assert sass.issue_floor_ms(1_045_440_000, 132, 1980.0) == pytest.approx(1.0)
