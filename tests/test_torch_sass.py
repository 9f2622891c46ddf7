"""The per-item instruction count that the chip smoke's kernel bounds use,
on SASS listings written in `cuobjdump -sass`'s format."""

import pytest

from repro_torch.kernels.sass import opcodes, per_item_ops, ptxas_usage

LISTING = """
\tcode for sm_90a
\t\tFunction : _ZN12_GLOBAL__N_117rmat_edges_kernelILi2EEEvPiS1_ljjjjj
\t.headerflags\t@"EF_CUDA_TEXMODE_UNIFIED EF_CUDA_64BIT_ADDRESS EF_CUDA_SM90"
        /*0000*/                   LDC R1, c[0x0][0x28] ;          /* 0x00000a00ff017b82 */
                                                                   /* 0x000fe40000000800 */
        /*0010*/                   S2R R0, SR_CTAID.X ;            /* 0x0000000000007919 */
        /*0020*/                   ULDC.64 UR4, c[0x0][0x210] ;    /* 0x0000840000047ab9 */
        /*0030*/                   ISETP.GE.U32.AND P0, PT, R0, UR4, PT ;
        /*0040*/               @P0 EXIT ;
        /*0050*/                   ULOP3.LUT UR6, UR4, 0x9e3779b9, URZ, 0x3c, !UPT ;
        /*0060*/                   IMAD R3, R0, 0x7feb352d, RZ ;
        /*0070*/                   STG.E desc[UR4][R2.64], R3 ;
        /*0080*/                   EXIT ;
        /*0090*/                   BRA 0x90 ;
        /*00a0*/                   NOP ;
        /*00b0*/                   NOP ;
\t\t..........

\t\tFunction : _ZN12_GLOBAL__N_117rmat_edges_kernelILi26EEEvPiS1_ljjjjj
        /*0000*/                   S2R R0, SR_CTAID.X ;
        /*0010*/                   EXIT ;
\t\t..........

\t\tFunction : _ZN12_GLOBAL__N_118bucket_hist_kernelEPKiliPi
        /*0000*/                   S2R R0, SR_TID.X ;
        /*0010*/                   STS [R0], RZ ;
        /*0020*/                   IADD3 R2, R0, 0x1, RZ ;
        /*0030*/              @!P1 BRA 0x20 ;
        /*0040*/                   LDG.E R4, desc[UR4][R2.64] ;
        /*0050*/                   LDG.E R5, desc[UR4][R2.64+0x400] ;
        /*0060*/                   MATCH.ANY R6, R4 ;
        /*0070*/                   POPC R7, R6 ;
        /*0080*/               @P0 ATOMS.ADD RZ, [R4], R7 ;
        /*0090*/                   UIADD3 UR6, UR6, 0x1, URZ ;
        /*00a0*/              @!P0 BRA 0x40 ;
        /*00b0*/                   EXIT ;
        /*00c0*/                   BRA 0xc0 ;
		..........

		Function : _ZN49_GLOBAL__N__c69a4754_16_graph_kernels_cu_91c5601418bucket_hist_kernelEPKiliPi
        /*0000*/                   S2R R10, SR_TID.X ;
        /*0010*/                   ISETP.GE.AND P0, PT, R10, UR5, PT ;
        /*0020*/                   IMAD.IADD R3, R4, 0x1, R3 ;
        /*0030*/              @!P0 BRA 0x20 ;
        /*0040*/                   IADD3 R7, P1, R10, UR6, RZ ;
        /*0050*/              @!P0 LDG.E.CONSTANT R6, desc[UR14][R4.64] ;
        /*0060*/                   UIADD3 UR6, UP0, UR6, UR8, URZ ;
        /*0070*/                   MATCH.ANY R7, R7 ;
        /*0080*/               @P1 BRA 0xa0 ;
        /*0090*/                   ATOMS.ADD RZ, [R6], R5 ;
        /*00a0*/                   BSYNC B0 ;
        /*00b0*/              @!P0 BRA 0x40 ;
        /*00c0*/                   EXIT ;
        /*00d0*/                   BRA 0xd0 ;
        /*00e0*/                   NOP ;
"""


@pytest.mark.parametrize("kernel,want", [
    # LDC S2R ISETP EXIT IMAD STG EXIT: the uniform ULDC/ULOP3, the
    # self-branch and the NOPs after the last EXIT do not count
    ("rmat_edges_kernelILi2E", 7),
    ("rmat_edges_kernelILi26E", 2),
    # the loop that loads: 6 thread instructions (UIADD3 is uniform) over 2
    # loads; the loop before it loads nothing
    ("N_118bucket_hist_kernel", 3),
    # the loop 0x40..0xb0 holds 7 thread instructions and one load
    ("_cu_91c5601418bucket_hist_kernel", 7),
])
def test_per_item_ops(kernel, want):
    assert per_item_ops(LISTING, kernel) == want


HIST_LISTING = """
\t\tFunction : _ZN49_GLOBAL__N__c69a4754_16_graph_kernels_cu_91c5601418bucket_hist_kernelILi8EEEvPKiiliiiPjS3_Pi
        /*0000*/                   S2R R0, SR_TID.X ;
        /*0010*/              @P1 LDG.E R4, desc[UR4][R2.64] ;
        /*0020*/                   LDG.E.128.CONSTANT R8, desc[UR4][R2.64] ;
        /*0030*/                   LDG.E.128.CONSTANT R12, desc[UR4][R2.64+0x1000] ;
        /*0040*/                   LOP3.LUT R5, R8, 0x3, RZ, 0xc0, !PT ;
        /*0050*/                   SHF.R.U32.HI R6, RZ, 0x2, R8 ;
        /*0060*/                   SHF.L.U32 R7, R5, 0x3, RZ ;
        /*0070*/                   ISETP.NE.U32.AND P0, PT, R6, RZ, PT ;
        /*0080*/              @!P0 IADD3 R20, R20, R7, RZ ;
        /*0090*/                   UIADD3 UR6, UR6, 0x1, URZ ;
        /*00a0*/                   ISETP.GE.AND P0, PT, R3, UR7, PT ;
        /*00b0*/              @!P0 BRA 0x20 ;
        /*00c0*/                   REDUX.SUM.S32 UR8, R20 ;
        /*00d0*/                   EXIT ;
\t\t..........

\t\tFunction : _ZN49_GLOBAL__N__c69a4754_16_graph_kernels_cu_91c5601418bucket_hist_kernelILi0EEEvPKiiliiiPjS3_Pi
        /*0000*/                   S2R R0, SR_TID.X ;
        /*0010*/                   LDG.E.64.CONSTANT R4, desc[UR4][R2.64] ;
        /*0020*/                   ISETP.GE.U32.AND P0, PT, R4, UR5, PT ;
        /*0030*/              @!P0 ATOMS.ADD RZ, [R6], R7 ;
        /*0040*/              @!P1 BRA 0x10 ;
        /*0050*/                   EXIT ;
"""


GATHER_LISTING = """
\t\tFunction : _ZN12_GLOBAL__N_121relabel_gather_kernelILb0EEEvPKiPi8MapShape9GatherMap
        /*0000*/                   S2R R0, SR_TID.X ;
        /*0010*/                   LDG.E.128 R4, desc[UR4][R2.64] ;
        /*0020*/                   LDG.E.CONSTANT R8, desc[UR4][R10.64] ;
        /*0030*/                   LDG.E.CONSTANT R9, desc[UR4][R12.64] ;
        /*0040*/                   LDG.E.CONSTANT R14, desc[UR4][R16.64] ;
        /*0050*/                   LDG.E.CONSTANT R15, desc[UR4][R18.64] ;
        /*0060*/                   STG.E.128 desc[UR4][R20.64], R8 ;
        /*0070*/                   IADD3 R3, R3, 0x1, RZ ;
        /*0080*/              @!P0 BRA 0x10 ;
        /*0090*/                   EXIT ;
"""


def test_per_item_ops_table_gathers_carry_no_items():
    """relabel_gather's loop: one 128-bit load of 4 keys and 4 gathers of
    the table; 8 thread instructions over the 4 keys, not over 8 loads' worth."""
    assert per_item_ops(GATHER_LISTING, "relabel_gather_kernelILb0E") == 2


@pytest.mark.parametrize("kernel,want", [
    # the loop 0x20..0xb0: 9 thread instructions (UIADD3 is uniform) over
    # two 128-bit loads of 4 items each; the head's 32-bit load before it
    # is not in the loop
    ("bucket_hist_kernelILi8E", 2),
    # 4 thread instructions over one 64-bit load of 2 items
    ("bucket_hist_kernelILi0E", 2),
])
def test_per_item_ops_counts_items_per_load_width(kernel, want):
    assert per_item_ops(HIST_LISTING, kernel) == want


def test_per_item_ops_needs_one_instance():
    """A templated kernel's name alone names every instance."""
    with pytest.raises(KeyError):
        per_item_ops(HIST_LISTING, "bucket_hist_kernel")


def test_per_item_ops_needs_one_function():
    with pytest.raises(KeyError):
        per_item_ops(LISTING, "rmat_edges_kernel")
    with pytest.raises(KeyError):
        per_item_ops(LISTING, "feistel_perm_kernel")


FLASH_LISTING = """
\t\tFunction : _ZN12_GLOBAL__N_130flash_attention_prefill_kernelILi128EEEv14CUtensorMap_st
        /*0000*/                   SYNCS.EXCH.64 URZ, [UR4], UR6 ;
        /*0010*/                   UTMALDG.3D [UR8], [UR10] ;
        /*0020*/                   HGMMA.64x128x16.F32.BF16 R24, gdesc[UR4], RZ, !UPT ;
        /*0030*/                   EXIT ;
\t\t..........

\t\tFunction : _ZN12_GLOBAL__N_129flash_attention_decode_kernelI13__nv_bfloat16Li128EEEvPKT_
        /*0000*/                   UBLKCP.S.G [UR4], [UR6], UR8 ;
        /*0010*/              @!P0 LDS.128 R4, [R2] ;
        /*0020*/                   EXIT ;
\t\t..........

\t\tFunction : _ZN12_GLOBAL__N_129flash_attention_decode_kernelIfLi16EEEvPKT_
        /*0000*/                   LDGSTS.E.128 [R2], desc[UR4][R4.64] ;
        /*0010*/                   EXIT ;
"""


@pytest.mark.parametrize("kernel,want", [
    ("flash_attention_prefill_kernel", [{"SYNCS", "UTMALDG", "HGMMA", "EXIT"}]),
    ("flash_attention_decode_kernel", [{"UBLKCP", "LDS", "EXIT"}, {"LDGSTS", "EXIT"}]),
    ("no_such_kernel", []),
])
def test_opcodes_per_function(kernel, want):
    got = opcodes(FLASH_LISTING, kernel)
    assert list(got.values()) == want
    assert all(kernel in name for name in got)


PTXAS_LOG = """ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_Z6decodeILi128EEvPKf' for 'sm_90a'
ptxas info    : Function properties for _Z6decodeILi128EEvPKf
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 152 registers, used 1 barriers
ptxas info    : Compiling entry function '_Z7prefillILi128EEvv' for 'sm_90a'
ptxas info    : Function properties for _Z7prefillILi128EEvv
    8 bytes stack frame, 4 bytes spill stores, 8 bytes spill loads
ptxas info    : Used 168 registers, used 1 barriers, 8 bytes cumulative stack size
"""


@pytest.mark.parametrize("name,want", [
    ("_Z6decodeILi128EEvPKf", {"registers": 152, "stack_bytes": 0, "spill_stores": 0,
                               "spill_loads": 0}),
    ("_Z7prefillILi128EEvv", {"registers": 168, "stack_bytes": 8, "spill_stores": 4,
                              "spill_loads": 8}),
])
def test_ptxas_usage(name, want):
    usage = ptxas_usage(PTXAS_LOG)
    assert set(usage) == {"_Z6decodeILi128EEvPKf", "_Z7prefillILi128EEvv"}
    assert usage[name] == want
