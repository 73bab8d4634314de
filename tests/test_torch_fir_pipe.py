"""The pipeline's probe on the CPU (``probes/fir_pipe.py``): the reading
of the machine code that counts each warp's group loop and its longest
chain of register dependences, on hand-written ``cuobjdump -sass`` text;
the instantiations it reports, found by name among the host-built
library's kernels; and the staged arms' entry, which on CPU tensors is the
fused tick's plain version.  The kernels themselves run in
``tests/test_torch_kernel_host.py`` (host build) and on the card."""

import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

from fdreadoutlibs_tpu_torch.ops import (TPGConfig, init_chanstate,
                                         seed_chanstate, tpg)
from fdreadoutlibs_tpu_torch.probes import fir_pipe
from fdreadoutlibs_tpu_torch.testing import (fir_stream, frame_words,
                                             time2_words, tpg_stream)
from torch_host_lib import host_library

NAME = ("_ZN12_GLOBAL__N_115fir_pipe_kernelILi0ELi1ELb0ELb0ELb1ELb0EEEvN3tpg"
        "6ParamsE")

# A loop at 0x20..0x70: R3 <- R2; P0 <- R3; R2 <- (P0) R3; R4 <- [R2];
# [R2] <- R4 is five dependent steps; the branch reads P0 only.
SASS = f"""
        Function : {NAME}
        .headerflags    @"EF_CUDA_SM90 EF_CUDA_VIRTUAL_SM(EF_CUDA_SM90)"
        /*0000*/                   MOV R1, c[0x0][0x28] ;                  /* 0x00000a00ff017624 */
        /*0010*/                   IADD3 R2, R1, 0x1, RZ ;                 /* 0x0000000101027810 */
        /*0020*/                   IADD3 R3, R2, R2, RZ ;                  /* 0x0000000202037210 */
        /*0030*/                   ISETP.GT.AND P0, PT, R3, 0x5, PT ;      /* 0x000000050300780c */
        /*0040*/              @P0  IADD3 R2, R3, 0x1, RZ ;                 /* 0x0000000103020810 */
        /*0050*/                   LDS R4, [R2+0x10] ;                     /* 0x0000100002047984 */
        /*0060*/                   STS [R2], R4 ;                          /* 0x0000000402007388 */
        /*0070*/              @!P0 BRA 0x20 ;                              /* 0xffffffa000008947 */
        /*0080*/                   EXIT ;                                  /* 0x000000000000794d */
"""


def test_sass_loop_and_chain():
    insns = fir_pipe.sass_kernels(SASS)[NAME]
    assert len(insns) == 9
    loops = fir_pipe.inner_loops(insns)
    assert [len(b) for b in loops] == [6]
    assert fir_pipe.chain_length(loops[0]) == 5
    got = fir_pipe.group_loops(insns, min_insns=4)
    assert got == [{"insns": 6, "per_tick": 6 / 16, "chain_per_tick": 5 / 16,
                    "lds": 1, "sts": 1, "mul": 0}]
    assert fir_pipe.group_loops(insns) == []       # no 16-tick body


def test_unpack_pass_is_read_below_a_group_loop_length():
    """K4b-slab's unpack pass over 16 ticks (32 shared loads, 8 shared
    stores) is shorter than a tick loop and still read; another loop of
    that length is not."""
    body = "".join(f"        /*{0x20 + 0x10 * i:04x}*/                   "
                   f"{op} ;\n" for i, op in enumerate(
                       ["LDS R4, [R2+0x10]"] * 32 + ["STS [R2], R4"] * 8
                       + ["IADD3 R2, R2, 0x4, RZ"] * 4))
    end = 0x20 + 0x10 * 44
    text = SASS.split("        /*0020*/")[0] + body + \
        f"        /*{end:04x}*/              @!P0 BRA 0x20 ;\n" \
        f"        /*{end + 0x10:04x}*/                   EXIT ;\n"
    insns = fir_pipe.sass_kernels(text)[NAME]
    got = fir_pipe.group_loops(insns)
    assert [(x["lds"], x["sts"], x["insns"]) for x in got] == \
        [(32, 8, 45)]
    assert fir_pipe._role(fir_pipe.ROLES["K4b-slab AbsRS"], got[0]) == \
        "unpack"
    other = text.replace("STS [R2], R4", "STS [R2+0x4], R4", 1) \
        .replace("LDS R4, [R2+0x10]", "IADD3 R4, R2, 0x1, RZ", 1)
    assert fir_pipe.group_loops(fir_pipe.sass_kernels(other)[NAME]) == []


def test_feed_options_name_the_schedules():
    assert fir_pipe.feed_options("words14-slab") == \
        (False, "words14", {"words14_slab": True})
    assert fir_pipe.feed_options("words14-gather") == \
        (False, "words14", {"words14_gather": True})
    assert fir_pipe.feed_options("time2") == (True, None, {})
    assert fir_pipe.feed_options("frames") == (False, "frames", {})


def test_a_loop_that_reads_no_shared_memory_is_no_group_loop():
    """The int16 feed's copy at an odd stride (global loads, shared
    stores) is a loop of the front warp but not its group loop."""
    text = SASS.replace("LDS R4, [R2+0x10]", "LDG.E R4, desc[UR4][R2.64]")
    insns = fir_pipe.sass_kernels(text)[NAME]
    assert [len(b) for b in fir_pipe.inner_loops(insns)] == [6]
    assert fir_pipe.group_loops(insns, min_insns=4) == []


@pytest.mark.parametrize("line,written,read", [
    ("IADD3 R4, P0, PT, R2, R3, RZ", {"R4", "P0"}, {"R2", "R3"}),
    ("ISETP.GE.AND P1, PT, R2, UR4, P0", {"P1"}, {"R2", "UR4", "P0"}),
    ("IMAD.WIDE R2, R5, 0x4, R6", {"R2", "R3"}, {"R5", "R6"}),
    ("SEL R7, R8, RZ, !P2", {"R7"}, {"R8", "P2"}),
    ("STS [R2+0x80], R9", set(), {"R2", "R9"}),
    ("LDS.64 R10, [R12]", {"R10", "R11"}, {"R12"}),
])
def test_sass_registers(line, written, read):
    op, _, rest = line.partition(" ")
    w, r = fir_pipe._regs(op, None, fir_pipe._operands(rest))
    assert (w, r) == (written, read)


@pytest.mark.parametrize("line,mul", [
    ("IMAD R6, R2, R3, R6", True), ("IMAD.WIDE.U32 R4, R2, 0xc, R8", True),
    ("IMUL R5, R2, R3", True), ("IMAD.MOV.U32 R5, RZ, RZ, R3", False),
    ("IMAD R23, RZ, RZ, -UR4", False), ("IMAD.IADD R4, R2, 0x1, R3", False),
    ("IMAD.SHL.U32 R4, R2, 0x4, RZ", False), ("IMAD.X R5, RZ, RZ, R7", False),
    ("IADD3 R4, R2, R3, RZ", False)])
def test_multiply_count(line, mul):
    """A multiply is an IMAD or IMUL with two non-zero factors: not the
    compiler's moves, adds and shifts in IMAD's form."""
    op, _, rest = line.partition(" ")
    assert fir_pipe._is_mul(op, fir_pipe._operands(rest)) is mul


def test_roles_told_apart_by_multiplies():
    """The threshold front and the running sum both load one word and store
    one a tick on plain samples; the running sum's multiplies tell them
    apart."""
    roles = fir_pipe.ROLES["K2 AbsRS"]
    loop = {"lds": 16, "sts": 16, "mul": 0}
    assert fir_pipe._role(roles, loop) == "loader + front"
    assert fir_pipe._role(roles, dict(loop, mul=32)) == "running sum"
    assert fir_pipe._role(roles, {"lds": 32, "sts": 0, "mul": 0}) == "hit"
    assert fir_pipe._role(fir_pipe.ROLES["K3"],
                          {"lds": 16, "sts": 32, "mul": 40}) == \
        "loader + front"


def test_reported_kernels_are_instantiated():
    """Each instantiation the probe reads is one kernel of the library
    (its name as the host compiler mangles it, which the card's compiler
    shares but for the anonymous namespace's name), and each role map has
    one role per warp of its mode."""
    nm = shutil.which("nm")
    if nm is None:
        pytest.skip("needs nm")
    lib = host_library("tpg")
    names = subprocess.run([nm, lib._name], capture_output=True, text=True,
                           check=True).stdout.split()
    names = {n for n in names if n.startswith("_ZN") and "pipe_kernel" in n
             and n.endswith("N3tpg6ParamsE")}
    for label, (enc, mode, channel, args) in fir_pipe.REPORTED.items():
        needle = re.compile(rf"pipe_kernelILi{enc}ELi{mode}EN\w*?"
                            rf"{len(channel)}{channel}I{args}EELb0E")
        assert len([n for n in names if needle.search(n)]) == 1, label
        warps = 1 if mode == 0 else 2 if mode == 1 or \
            label.endswith("SimpleThreshold") else 3
        # K4b-slab's warp 0 runs the unpack pass beside its front
        roles = set(fir_pipe.ROLES[label].values()) - {"unpack"}
        assert len(roles) == warps, label
        assert ("unpack" in fir_pipe.ROLES[label].values()) == \
            (enc == tpg._SLAB14), label


def test_chain_floor_is_the_longest_warp():
    sass = {"K3": {"loader + front": {"chain_per_tick": 12.0},
                   "filter + hit": {"chain_per_tick": 7.5}}}
    # 12 steps x 4 cycles x 8192 ticks at 2000 MHz
    assert fir_pipe.chain_floor_ms(sass, 4.0, 2000.0) == {
        "K3": 12 * 4 * 8192 / 2e6}


@pytest.mark.parametrize("time2", [False, True])
def test_staged_entry_on_cpu_is_k3_plain(time2):
    cfg = TPGConfig.from_raw("FIR", threshold=5)
    C, T, tc = 96, 192, 64
    adcs = fir_stream(T, C, tc, 2, seed=4)
    state = tpg.pack_state(seed_chanstate(init_chanstate(C), adcs[0], 0), C)
    feed = torch.from_numpy(time2_words(adcs) if time2 else adcs)
    got = fir_pipe.staged_launch(feed, state, cfg, tc, 2, time2)
    want = tpg.process_window_plain(torch.from_numpy(adcs), state, cfg, tc,
                                    2, False)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert fir_pipe.launches == 0
    assert int(np.asarray(want[1]).max()) > 2


@pytest.mark.parametrize("packed14", [None, "frames", "words14", "time2",
                                      "int16"])
def test_threshold_staged_entry_on_cpu_is_plain(packed14):
    """The threshold staged arm's entry on CPU tensors: the fused tick's
    plain version on plain samples, packed words, time2 rows and int16
    samples and state; no launch."""
    from fdreadoutlibs_tpu_torch.ops.ingest import pack_words14
    cfg = TPGConfig.from_raw("AbsRS", threshold=150)
    C, T, tc = 128, 192, 64
    adcs, rmf = tpg_stream(T, C, tc, 2, seed=6)
    state = tpg.pack_state(seed_chanstate(init_chanstate(C), adcs[0], rmf),
                           C)
    feed = torch.from_numpy(adcs)
    time2 = packed14 == "time2"
    if time2:
        feed = torch.from_numpy(time2_words(adcs))
    elif packed14 == "int16":
        feed, state = feed.to(torch.int16), state.to(torch.int16)
    elif packed14 is not None:
        feed = torch.from_numpy(frame_words(adcs).view(np.int32))
        if packed14 == "words14":
            feed = pack_words14(feed)
    layout = packed14 if packed14 in ("frames", "words14") else None
    got = fir_pipe.staged_launch(feed, state, cfg, tc, 2, time2, layout)
    want = tpg.process_window_plain(torch.from_numpy(adcs),
                                    state.to(torch.int32), cfg, tc, 2, False)
    for g, w in zip(got, want):
        assert torch.equal(g.to(torch.int32), w)
    assert fir_pipe.launches == 0


def test_kernel_of_names_the_function_a_launch_runs():
    """A launch counts once for the kernel function it runs (chip_smoke.py's
    rows), where ``kernels_of`` names every kernel on its datapath: FIR on
    plain samples is K3's function on K2's datapath."""
    fir = TPGConfig.from_raw("FIR", threshold=5)
    absrs = TPGConfig.from_raw("AbsRS", threshold=150)
    assert tpg.kernels_of(fir, False) == ("K2", "K3")
    assert tpg.kernel_of(fir, False) == tpg.kernel_of(fir, True) == "K3"
    assert tpg.kernel_of(absrs, False) == "K2"
    assert tpg.kernel_of(absrs, True) == "K1"
    assert tpg.kernel_of(fir, False, "frames") == "K4"
    assert tpg.kernel_of(fir, False, fir_twopass=2) == "K5"
    assert tpg.kernel_of(fir, False, fir_packed=True) == "K3b"
    assert tpg.kernel_of(absrs, False, int16=True) == "K2b"
    assert tpg.kernel_of(absrs, False, "words14", words14_gather=True) == \
        "K4b-gather"
    tpg.reset_launches()
    tpg.count_launch(fir, False, None, 0, int16=False, fir_packed=False,
                     words14_gather=False, words14_slab=False)
    assert tpg.process_window.function_launches["K3"] == 1
    assert tpg.process_window.function_launches["K2"] == 0
    assert tpg.process_window.kernel_launches["K2"] == 1
    tpg.reset_launches()
