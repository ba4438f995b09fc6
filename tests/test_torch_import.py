"""svc_tpu_torch imports neither JAX nor anything of svc_tpu (it keeps its
own host layer), resolves devices strictly, and registers one CUDA kernel
per TPU kernel."""

import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# top-level packages the port must never load: JAX, the JAX package and
# its benchmarks
FORBIDDEN = ("jax", "jaxlib", "svc_tpu", "benchmarks")


def test_port_imports_no_jax():
    code = (
        "import sys\n"
        "import svc_tpu_torch, svc_tpu_torch.models.encoder, "
        "svc_tpu_torch.models.decoder, svc_tpu_torch.apps.encoder_app, "
        "svc_tpu_torch.apps.decoder_app, svc_tpu_torch.tools.profile_slice, "
        "svc_tpu_torch.ops.motion, svc_tpu_torch.io.video, "
        "svc_tpu_torch.metrics, svc_tpu_torch.runtime.pipeline, "
        "svc_tpu_torch.runtime.tracing, svc_tpu_torch.runtime.staging, "
        "svc_tpu_torch.visualize, svc_tpu_torch.parallel.sharding, "
        "svc_tpu_torch.runtime.graphs, svc_tpu_torch.ops.ccl, "
        "svc_tpu_torch.ops.prng\n"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r})\n"
        "assert not bad, bad\n"
        "print('clean')\n"
    )
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "clean"


def test_port_sources_have_no_jax_import_line():
    pkg = os.path.join(REPO, "svc_tpu_torch")
    paths = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, files in os.walk(pkg):
        paths += [os.path.join(root, n) for n in files if n.endswith(".py")]
    bad_import = re.compile(
        r"^\s*(from|import)\s+(jax|jaxlib|svc_tpu|benchmarks)(\.|\s|$)"
    )
    for path in paths:
        with open(path) as f:
            for line in f:
                assert not bad_import.match(line), (path, line)


def _no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_resolve_device_raises_without_card(monkeypatch):
    from svc_tpu_torch.runtime.device import resolve_device

    _no_cuda(monkeypatch)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError):
        resolve_device(torch.device("cuda", 0))
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError, match="unsupported device type"):
        resolve_device("meta")


def test_entry_points_refuse_cuda_without_card(monkeypatch):
    from svc_tpu_torch.config import DecoderConfig, EncoderConfig, VideoProperties
    from svc_tpu_torch.io import bitstream
    from svc_tpu_torch.models.decoder import Decoder
    from svc_tpu_torch.models.encoder import Encoder

    _no_cuda(monkeypatch)
    with pytest.raises(RuntimeError):
        Encoder(EncoderConfig(reference_compat=True),
                VideoProperties(64, 64, 3), device="cuda")
    hdr = bitstream.Header(2, 64, 64, 0, 0, 8, 8, 3)
    with pytest.raises(RuntimeError):
        Decoder(DecoderConfig(), hdr, device="cuda")


def test_staging_on_cuda_without_card_raises(monkeypatch):
    # an encoder and a decoder built for cuda:0, whose card is then gone:
    # staging raises instead of copying through pageable memory or the CPU
    from svc_tpu_torch.config import DecoderConfig, EncoderConfig, VideoProperties
    from svc_tpu_torch.io import bitstream
    from svc_tpu_torch.models.decoder import Decoder
    from svc_tpu_torch.models.encoder import Encoder

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    enc = Encoder(EncoderConfig(), VideoProperties(64, 48, 3), device="cuda:0")
    dec = Decoder(DecoderConfig(), bitstream.Header(2, 64, 48, 0, 0, 8, 8, 3),
                  device="cuda:0")
    _no_cuda(monkeypatch)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        enc.stage_frames([np.zeros((48, 64, 3), np.uint8)] * 3)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dec.stage_coeffs(np.zeros((2, 6, 8, 192), np.float32))


@pytest.mark.parametrize(
    "call",
    [
        lambda: __import__(
            "svc_tpu_torch.ops.pyramid", fromlist=["x"]
        ).pyr_down(torch.zeros((2, 8, 8), dtype=torch.uint8, device="meta")),
        lambda: __import__(
            "svc_tpu_torch.ops.dct", fromlist=["x"]
        ).dct8x8_to_wire(
            torch.zeros((2, 8, 24), dtype=torch.uint8, device="meta"), 1, 1, 8, 8
        ),
    ],
)
def test_wrappers_refuse_devices_they_do_not_run_on(call):
    # a wrapper takes its plain version only for CPU tensors; any other
    # device launches a kernel (cuda) or raises
    with pytest.raises(ValueError, match="unsupported device"):
        call()


def test_kernel_registry_names_sources_and_tpu_kernels():
    from svc_tpu_torch.kernels import build
    from svc_tpu_torch.ops import ccl, dct, kmeans, motion, prng, pyramid  # noqa: F401

    ks = build.kernels()
    assert set(ks) == {
        "pyr_down_u8", "refine_sads", "dct8x8_to_wire", "idct_display",
        "lloyd", "idct_resize_display", "refine_mads", "candidate_sads",
        "pyr_down_pitched_general", "pyr_down_pitched_levels",
        "refine_sads_pitched", "dct_to_wire_general",
        "idct_display_general", "refine_sads_general", "lloyd_general",
        "candidate_sads_general", "pyr_down_levels",
        "idct_resize_display_general", "refine_sads_pitched_general",
        "refine_mads_general", "ccl_converge", "ccl_converge_general",
        "threefry2x32",
    }
    # K10 (both kernels) and K11 replace no pl.pallas_call: svc_tpu's CCL
    # while_loop and jax.random's threefry (its k-means++ seeding draw)
    no_pallas = {"ccl_converge": "jax.lax.while_loop(",
                 "ccl_converge_general": "jax.lax.while_loop(",
                 "threefry2x32": "jax.random.uniform("}
    for k in ks.values():
        assert os.path.isfile(os.path.join(REPO, k.source)), k.source
        path, line = k.replaces.split(":")
        with open(os.path.join(REPO, path)) as f:
            text = f.read().splitlines()
        if k.name in no_pallas:
            assert no_pallas[k.name] in text[int(line) - 1], k.replaces
        else:
            assert text[int(line) - 1].startswith("def "), k.replaces
    srcs = {p.name for p in build.sources()}
    assert {"pyr_down.cu", "refine_sads.cu", "dct_wire.cu",
            "idct_display.cu", "lloyd.cu", "idct_resize.cu",
            "idct_tile.cuh", "refine_mads.cu", "candidate_sads.cu",
            "pyr_down_pitched.cu", "refine_sads_pitched.cu", "window_sads.cuh",
            "pyr_down.cuh", "planes.cuh", "dct_wire_general.cu",
            "idct_display_general.cu", "refine_sads_general.cu",
            "lloyd_general.cu", "lloyd.cuh", "candidate_sads_general.cu",
            "pyr_down_levels.cu", "idct_resize_general.cu",
            "idct8x8.cuh", "refine_sads_pitched_general.cu",
            "refine_rows.cuh", "pyr_down_pitched_levels.cu",
            "pyr_down_levels.cuh", "refine_mads_general.cu",
            "refine_sads.cuh", "ccl_converge.cu", "ccl_converge_general.cu",
            "threefry.cu"} <= srcs
    assert len({k.source for k in ks.values()}) == len(ks)  # one file each
    # sources are found relative to the package, not the working directory
    assert build.CSRC_DIR == build.PACKAGE_DIR / "csrc"


def test_launch_counters_reset():
    from svc_tpu_torch.kernels import build
    from svc_tpu_torch.ops import pyramid

    pyramid.PYR_DOWN.launches = 3
    build.reset_launch_counts()
    assert build.launch_counts()["pyr_down_u8"] == 0
    # the CPU path takes the plain version and launches nothing
    pyramid.pyr_down(torch.zeros((1, 8, 8), dtype=torch.uint8))
    assert build.launch_counts()["pyr_down_u8"] == 0


def test_nvcc_flags_keep_ieee_division():
    from svc_tpu_torch.kernels import build

    flags = " ".join(build.NVCC_FLAGS)
    assert "arch=compute_90a,code=sm_90a" in flags
    assert "fast_math" not in flags and "fast-math" not in flags
    assert np.all([f in build.NVCC_FLAGS for f in ("-O3", "-shared")])
