"""The bookkeeping of ``chip_smoke.py`` and ``tools/variant_timing.py`` that
runs without a card: the integer rate, K11's cipher count from SASS, the
ptxas report of K10's two kernels, the variant build's edits and its
probes' report."""

import importlib.util
import os
import types

import pytest
import torch

from svc_tpu_torch.kernels import build
from svc_tpu_torch.ops import ccl
from svc_tpu_torch.tools import variant_timing

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _cipher_loop(rotations: int):
    """A threefry-like function: a prologue add, a grid-stride loop of
    ``rotations`` add / rotate / xor rounds, the key parity, an injection,
    a store, then a subroutine after EXIT."""
    body = ["LOP3.LUT R4, R3, UR20, RZ, 0xfc, !PT", "ISETP.NE.U32.AND P0, PT, R4, RZ, PT"]
    for _ in range(rotations):
        body += ["IMAD.IADD R11, R11, 0x1, R10", "SHF.L.W.U32.HI R10, R10, 0xd, R10",
                 "LOP3.LUT R10, R11, R10, RZ, 0x3c, !PT"]
    body += ["LOP3.LUT R6, R4, 0x1bd11bda, R5, 0x96, !PT", "IADD3 R7, R6, 0x1, R7",
             "STG.E.64 desc[UR10][R6.64], R4", "IMAD.WIDE.U32 R2, R0, 0x100, R2"]
    head = 0x20
    sass = [(0x00, "S2R R5, SR_CTAID.X"), (0x10, "IADD3 R1, R2, R3, RZ")]
    sass += [(head + 16 * i, ins) for i, ins in enumerate(body)]
    end = head + 16 * len(body)
    sass += [(end, f"BRA {hex(head)}"), (end + 16, "EXIT"),
             (end + 32, "IADD3 R8, P0, RZ, -R8, RZ")]
    return sass


def test_cipher_instructions_count_the_loop_only(smoke):
    # 20 rounds of add, rotate, xor; the parity xor and one injection add
    assert smoke.cipher_instructions(_cipher_loop(20)) == 20 * 3 + 2


def test_cipher_instructions_refuse_a_loop_without_the_cipher(smoke):
    with pytest.raises(SystemExit):
        smoke.cipher_instructions(_cipher_loop(19))


def test_sass_of_picks_one_function_and_drops_predicates(smoke, monkeypatch):
    dump = "\n".join([
        "\tcode for sm_90a",
        "\t\tFunction : _ZN44_GLOBAL__N__62c2f595_11_threefry_cu_37df92e819threefry2x32_kernelEPKl",
        "        /*0000*/                   LDC R1, c[0x0][0x28] ;   /* 0x0000 */",
        "        /*01a0*/               @!P0 BRA 0x200 ;             /* 0x0001 */",
        "        /*0950*/                @P0 EXIT ;                  /* 0x0002 */",
        "\t\tFunction : _ZN48_GLOBAL__N__2147b2ad_15_ccl_converge_cu_3b201d6718ccl_cluster_kernelEPKi",
        "        /*0000*/                   S2R R0, SR_TID.X ;       /* 0x0003 */",
    ])
    monkeypatch.setattr(build, "find_nvcc", lambda: "/toolkit/bin/nvcc")
    calls = []

    def run(cmd, **kw):
        calls.append(cmd)
        return types.SimpleNamespace(returncode=0, stdout=dump, stderr="")

    monkeypatch.setattr(smoke.subprocess, "run", run)
    got = smoke.sass_of("lib.so", "threefry2x32_kernel")
    assert got == [(0x0, "LDC R1, c[0x0][0x28]"), (0x1a0, "BRA 0x200"), (0x950, "EXIT")]
    assert calls == [["/toolkit/bin/cuobjdump", "-sass", "lib.so"]]
    with pytest.raises(SystemExit):  # no such function
        smoke.sass_of("lib.so", "lloyd_cluster_kernel")


def test_int_ops_per_s_is_64_a_clock_on_each_sm(smoke, monkeypatch):
    monkeypatch.setattr(smoke.subprocess, "run", lambda *a, **k: types.SimpleNamespace(
        returncode=0, stdout="1980\n", stderr=""))
    monkeypatch.setattr(smoke.torch.cuda, "get_device_properties",
                        lambda i: types.SimpleNamespace(multi_processor_count=132))
    rate, sms, mhz = smoke.int_ops_per_s()
    assert (sms, mhz) == (132, 1980.0) and rate == pytest.approx(64 * 132 * 1.98e9)


def test_ptxas_report_names_both_k10_kernels(smoke):
    log = "\n".join([
        "ptxas info    : Compiling entry function '_ZN48_GLOBAL__N__2147b2ad_15_"
        "ccl_converge_cu_3b201d6718ccl_cluster_kernelEPKiPiiii' for 'sm_90a'",
        "ptxas info    : Used 28 registers, used 1 barriers",
        "ptxas info    : Compiling entry function '_ZN56_GLOBAL__N__44309d9f_23_"
        "ccl_converge_general_cu_b71b0f3a19ccl_converge_kernelILi1EEEvPKiPiPhiii' "
        "for 'sm_90a'",
        "ptxas info    : Used 32 registers, used 1 barriers",
    ])
    report = smoke.ptxas_report(log)
    assert report == [("ccl_converge.cu", "ccl_cluster_kernel", 28, 0),
                      ("ccl_converge_general.cu", "ccl_converge_kernel<1>", 32, 0)]
    line = smoke.k10_occupancy(ccl, "ccl_cluster_kernel", 28)
    assert line.startswith("5400 B dynamic smem a CTA at 68x120 (2 CTAs per SM)")
    assert "81600 B dynamic smem a CTA at 270x480" in line
    assert smoke.k10_occupancy(ccl, "ccl_converge_kernel<0>", 31) == "over global memory"


def test_variant_build_applies_every_edit_once(monkeypatch, tmp_path):
    monkeypatch.setattr(variant_timing, "VARIANT_DIR", tmp_path)
    seen = {}

    def fake_build():
        seen["csrc"] = build.CSRC_DIR
        seen["text"] = (build.CSRC_DIR / "ccl_converge.cu").read_text()
        return "built"

    monkeypatch.setattr(build, "build", fake_build)
    got = variant_timing.build_variant([
        ("ccl_converge.cu", "constexpr int kCluster = 8;", "constexpr int kCluster = 16;"),
        ("ccl_converge.cu", "constexpr int kThreads = 1024;", "constexpr int kThreads = 512;"),
    ])
    assert got == "built" and seen["csrc"] == tmp_path / "csrc"
    assert "kCluster = 16;" in seen["text"] and "kThreads = 512;" in seen["text"]
    # the checkout's own sources and build directory are left as they were
    assert build.CSRC_DIR == build.PACKAGE_DIR / "csrc"
    assert "kCluster = 8;" in (build.CSRC_DIR / "ccl_converge.cu").read_text()
    with pytest.raises(SystemExit, match="not once"):
        variant_timing.build_variant([("ccl_converge.cu", "no such text", "x")])


def test_variant_probe_reports_how_far_its_outputs_are():
    # an unchecked probe's times are printed beside its distance from the
    # base build: the largest difference and the share of elements
    a = torch.tensor([10, 20, 30, 40], dtype=torch.uint8)
    b = torch.tensor([10, 21, 30, 37], dtype=torch.uint8)
    assert variant_timing.diff(a, b) == "outputs differ, max |diff| 3 on 50.0000% of elements"
    pair = (torch.zeros(3), torch.tensor([0.0, 0.5, 0.0]))
    assert variant_timing.diff(pair, (torch.zeros(3), torch.zeros(3))) == (
        "outputs differ, max |diff| 0.5 on 16.6667% of elements")


def test_variant_docstring_edits_apply_once():
    # the edits the tool's docstring gives as examples each occur exactly
    # once in the checkout's sources, so they run as written
    for path, old in (("pyr_down_levels.cuh", "__launch_bounds__(kLvThreads, 6)"),
                      ("idct_display_sq.cu", "kCoefGroup = 336, kMinCtas = 3,"),
                      ("idct_resize_sq.cu", "kCoefGroup = 36, kHaloColumns = 4"),
                      ("ccl_converge.cu", "kCluster = 8;"),
                      ("refine_sads.cu", "constexpr int kSplitRows = 4;")):
        assert old in variant_timing.__doc__
        assert (build.CSRC_DIR / path).read_text().count(old) == 1, (path, old)
    assert set(variant_timing.KERNEL) == set(variant_timing.WORK)


def test_ptxas_report_names_the_square_k6_instances(smoke):
    # the template kernel of idct_resize_sq.cu takes (rows, columns): one
    # entry per block shape, rows first, the squares' too
    log = "\n".join([
        "ptxas info    : Compiling entry function '_ZN50_GLOBAL__N__e38884e4_17_idct_resize_sq_cu_"
        "7581c29221idct_sq_resize_kernelILi16ELi16EEEvPKfS2_NS_4DctFIXT_EXT0_EEEPKiS6_S2_S6_S6_"
        "S6_S2_S6_Phiiiii' for 'sm_90a'",
        "ptxas info    : Used 64 registers, used 1 barriers",
        "ptxas info    : Compiling entry function '_ZN50_GLOBAL__N__e38884e4_17_idct_resize_sq_cu_"
        "7581c29221idct_sq_resize_kernelILi4ELi16EEEvPKfS2_NS_4DctFIXT_EXT0_EEEPKiS6_S2_S6_S6_"
        "S6_S2_S6_Phiiiii' for 'sm_90a'",
        "ptxas info    : Used 47 registers, used 1 barriers",
    ])
    assert smoke.ptxas_report(log) == [
        ("idct_resize_sq.cu", "idct_sq_resize_kernel<16, 16>", 64, 0),
        ("idct_resize_sq.cu", "idct_sq_resize_kernel<4, 16>", 47, 0)]


def test_ptxas_report_names_the_side_1_and_2_k6_instances(smoke):
    # K6's template at a side of 1 or 2 (rows first, one-digit sides and a
    # 16): one entry per shape, with its spill stores
    mangled = ("_ZN50_GLOBAL__N__e38884e4_17_idct_resize_sq_cu_7581c29221"
               "idct_sq_resize_kernelILi{}ELi{}EEEvPKfS2_NS_4DctFIXT_EXT0_EEE"
               "PKiS6_S2_S6_S6_S6_S2_S6_Phiiiii")
    log = "\n".join([
        f"ptxas info    : Compiling entry function '{mangled.format(1, 1)}' "
        "for 'sm_90a'",
        f"ptxas info    : Function properties for {mangled.format(1, 1)}",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 40 registers, used 1 barriers",
        f"ptxas info    : Compiling entry function '{mangled.format(2, 16)}' "
        "for 'sm_90a'",
        f"ptxas info    : Function properties for {mangled.format(2, 16)}",
        "    24 bytes stack frame, 20 bytes spill stores, 20 bytes spill loads",
        "ptxas info    : Used 64 registers, used 1 barriers",
        f"ptxas info    : Compiling entry function '{mangled.format(16, 1)}' "
        "for 'sm_90a'",
        "ptxas info    : Used 72 registers, used 1 barriers",
    ])
    assert smoke.ptxas_report(log) == [
        ("idct_resize_sq.cu", "idct_sq_resize_kernel<1, 1>", 40, 0),
        ("idct_resize_sq.cu", "idct_sq_resize_kernel<2, 16>", 64, 0),
        ("idct_resize_sq.cu", "idct_sq_resize_kernel<16, 1>", 72, 0)]
    assert smoke.ptxas_spills(log) == {"idct_sq_resize_kernel<1, 1>": 0,
                                       "idct_sq_resize_kernel<2, 16>": 20,
                                       "idct_sq_resize_kernel<16, 1>": 0}


def test_ptxas_report_names_the_templated_k2_k1_instances(smoke):
    # the templates of dct_wire_sq.cu and idct_display_sq.cu take (rows,
    # columns): one entry per block shape, rows first, with its spill stores
    log = "\n".join([
        "ptxas info    : Compiling entry function '_ZN47_GLOBAL__N__93b7408a_14_dct_wire_sq_cu_"
        "04e6972d18dct_sq_wire_kernelILi16ELi8EEEvPKhNS_4DctDIXT_EXT0_EEEPfiiiii' for 'sm_90a'",
        "ptxas info    : Function properties for _ZN47_GLOBAL__N__93b7408a_14_dct_wire_sq_cu_"
        "04e6972d18dct_sq_wire_kernelILi16ELi8EEEvPKhNS_4DctDIXT_EXT0_EEEPfiiiii",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 56 registers, used 1 barriers",
        "ptxas info    : Compiling entry function '_ZN51_GLOBAL__N__2947429e_18_idct_display_sq_cu_"
        "864b1bd722idct_sq_display_kernelILi8ELi16EEEvPKfS2_NS_4DctFIXT_EXT0_EEEPKiS6_S2_S6_S6_"
        "Phiiii' for 'sm_90a'",
        "ptxas info    : Function properties for _ZN51_GLOBAL__N__2947429e_18_idct_display_sq_cu_"
        "864b1bd722idct_sq_display_kernelILi8ELi16EEEvPKfS2_NS_4DctFIXT_EXT0_EEEPKiS6_S2_S6_S6_"
        "Phiiii",
        "    416 bytes stack frame, 412 bytes spill stores, 412 bytes spill loads",
        "ptxas info    : Used 64 registers, used 1 barriers",
    ])
    assert smoke.ptxas_report(log) == [
        ("dct_wire_sq.cu", "dct_sq_wire_kernel<16, 8>", 56, 0),
        ("idct_display_sq.cu", "idct_sq_display_kernel<8, 16>", 64, 0)]
    assert smoke.ptxas_spills(log) == {"dct_sq_wire_kernel<16, 8>": 0,
                                       "idct_sq_display_kernel<8, 16>": 412}


def test_ptxas_report_names_the_radius_instances(smoke):
    # K3's template takes (block, radius), its split kernel (16x16 blocks)
    # and K9's the radius: one entry per instance, as chip_smoke's phase 2
    # reports their registers and CTAs
    log = "\n".join([
        "ptxas info    : Compiling entry function '_ZN46_GLOBAL__N__c2cfe8a7_14_refine_sads_cu_"
        "a44f72fb18refine_sads_kernelILi16ELi4EEEvPKhS2_mPKiPiiiii' for 'sm_90a'",
        "ptxas info    : Used 79 registers, used 1 barriers, 5184 bytes smem",
        "ptxas info    : Compiling entry function '_ZN46_GLOBAL__N__c2cfe8a7_14_refine_sads_cu_"
        "a44f72fb18refine_sads_kernelILi4ELi1EEEvPKhS2_mPKiPiiiii' for 'sm_90a'",
        "ptxas info    : Used 32 registers, used 1 barriers, 2304 bytes smem",
        "ptxas info    : Compiling entry function '_ZN49_GLOBAL__N__0b7d8c2e_17_candidate_sads_cu_"
        "7d395fff21candidate_sads_kernelILi3EEEvPKhS2_PKiPfiiii' for 'sm_90a'",
        "ptxas info    : Used 40 registers, used 0 barriers",
        "ptxas info    : Compiling entry function '_ZN46_GLOBAL__N__c2cfe8a7_14_refine_sads_cu_"
        "a44f72fb24refine_sads_split_kernelILi2EEEvPKhS2_mPKiPiiiii' for 'sm_90a'",
        "ptxas info    : Used 64 registers, used 1 barriers, 6400 bytes smem",
    ])
    assert smoke.ptxas_report(log) == [
        ("refine_sads.cu", "refine_sads_kernel<16, 4>", 79, 5184),
        ("refine_sads.cu", "refine_sads_kernel<4, 1>", 32, 2304),
        ("candidate_sads.cu", "candidate_sads_kernel<3>", 40, 0),
        ("refine_sads.cu", "refine_sads_split_kernel<2>", 64, 6400)]
    # 256 threads: 79 registers (80 a thread allotted) hold 3 CTAs an SM,
    # 32 hold 8
    assert smoke.ctas_per_sm(79, 5184, 256) == 3
    assert smoke.ctas_per_sm(32, 2304, 256) == 8


def test_ptxas_report_names_the_output_type_instances(smoke):
    # K3's kernel and K9's 2x2 kernel also take their output type (float32
    # for K9, int32 for K3 / K7): each instance named with it; K9's 1x1
    # kernel takes the radius alone
    log = "\n".join([
        "ptxas info    : Compiling entry function '_ZN46_GLOBAL__N__c2cfe8a7_14_refine_sads_cu_"
        "a44f72fb18refine_sads_kernelILi8ELi4EfEEvPKhS2_mPKiPT1_iiii' for 'sm_90a'",
        "ptxas info    : Used 63 registers, used 1 barriers, 10368 bytes smem",
        "ptxas info    : Compiling entry function '_ZN46_GLOBAL__N__c2cfe8a7_14_refine_sads_cu_"
        "a44f72fb18refine_sads_kernelILi8ELi4EiEEvPKhS2_mPKiPT1_iiii' for 'sm_90a'",
        "ptxas info    : Used 63 registers, used 1 barriers, 10368 bytes smem",
        "ptxas info    : Compiling entry function '_ZN49_GLOBAL__N__0b7d8c2e_17_candidate_sads_cu_"
        "7d395fff21candidate_sads_kernelILi1EiEEvPKhS2_mPKiPT0_iiii' for 'sm_90a'",
        "ptxas info    : Used 26 registers, used 0 barriers",
        "ptxas info    : Compiling entry function '_ZN49_GLOBAL__N__0b7d8c2e_17_candidate_sads_cu_"
        "7d395fff25candidate_sads_1x1_kernelILi2EEEvPKhS2_PKiPfii' for 'sm_90a'",
        "ptxas info    : Used 30 registers, used 0 barriers",
    ])
    assert smoke.ptxas_report(log) == [
        ("refine_sads.cu", "refine_sads_kernel<8, 4, float>", 63, 10368),
        ("refine_sads.cu", "refine_sads_kernel<8, 4, int>", 63, 10368),
        ("candidate_sads.cu", "candidate_sads_kernel<1, int>", 26, 0),
        ("candidate_sads.cu", "candidate_sads_1x1_kernel<2>", 30, 0)]


def test_ptxas_report_names_the_rect_instances(smoke):
    # K3's and K9's kernels take (width, height, radius) and the output
    # type, the split kernel (height, radius): every template argument in
    # the name, as phase 2 reports the 16x8 and 8x16 MV blocks' instances
    log = "\n".join([
        "ptxas info    : Compiling entry function '_ZN46_GLOBAL__N__c2cfe8a7_14_refine_sads_cu_"
        "a44f72fb18refine_sads_kernelILi16ELi8ELi4EiEEvPKhS2_mPKiPT2_iiii' for 'sm_90a'",
        "ptxas info    : Used 77 registers, used 1 barriers, 10368 bytes smem",
        "ptxas info    : Compiling entry function '_ZN46_GLOBAL__N__c2cfe8a7_14_refine_sads_cu_"
        "a44f72fb24refine_sads_split_kernelILi8ELi4EEEvPKhS2_mPKiPiiiii' for 'sm_90a'",
        "ptxas info    : Used 103 registers, used 1 barriers, 41472 bytes smem",
        "ptxas info    : Compiling entry function '_ZN49_GLOBAL__N__0b7d8c2e_17_candidate_sads_cu_"
        "7d395fff21candidate_sads_kernelILi1ELi2ELi3EfEEvPKhS2_PKiPT2_iiii' for 'sm_90a'",
        "ptxas info    : Used 40 registers, used 0 barriers",
    ])
    assert smoke.ptxas_report(log) == [
        ("refine_sads.cu", "refine_sads_kernel<16, 8, 4, int>", 77, 10368),
        ("refine_sads.cu", "refine_sads_split_kernel<8, 4>", 103, 41472),
        ("candidate_sads.cu", "candidate_sads_kernel<1, 2, 3, float>", 40, 0)]
    # 128 blocks of 2 lanes a CTA: 103 registers (104 a thread allotted)
    # hold 2 CTAs of 256 an SM
    assert smoke.ctas_per_sm(103, 41472, 256) == 2


def test_setting_levels_hold_every_instance_once(smoke):
    # phase 3's settings past the default reach every specialised K9 and
    # K3 block that the default's own levels (K9 2x2; K3 4x4, 8x8, 16x16)
    # do not, each at one setting only, at the level its setting's encoder
    # runs it on
    from svc_tpu_torch.ops import motion

    plan = smoke.setting_levels()
    k9 = [(mw >> lvl, mh >> lvl) for (mw, mh, _), top, _ in plan for lvl in top]
    k3 = [(mw >> lvl, mh >> lvl) for (mw, mh, _), _, refine in plan for lvl in refine]
    assert sorted(k9) == sorted(motion._K9_BLOCKS - {(2, 2)})
    assert sorted(k3) == sorted(motion._K3_BLOCKS - {(4, 4), (8, 8), (16, 16)})
    for (mw, mh, levels), top, refine in plan:
        assert top in ([], [levels - 1])
        assert all(0 <= lvl < levels - 1 for lvl in refine)
    assert plan[0] == ((8, 8, 4), [3], [2])  # 1x1 on top, 2x2 under it
    assert plan[1] == ((16, 16, 3), [2], [])  # 4x4 on top; its K3 blocks are the default's
