"""The bookkeeping of ``chip_smoke.py`` and ``tools/variant_timing.py`` that
runs without a card: the integer rate, K11's cipher count from SASS, the
ptxas report of K10's two kernels, and the variant build's edits."""

import importlib.util
import os
import types

import pytest

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
