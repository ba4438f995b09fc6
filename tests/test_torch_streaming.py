"""The port's streaming runtime against svc_tpu's, on the CPU at 48x64.

The stager, the pipeline threads and the tracer keep svc_tpu's contracts
(tests/test_staging.py, tests/test_pipeline.py, tests/test_resume_tracing.py);
the staged, one-batch-in-flight ``stream_encode`` equals direct per-batch
encoding byte for byte and svc_tpu's stream within the DCT gate; both
streaming loops record svc_tpu's span sequence and call ``on_batch`` with
svc_tpu's arguments; decode with and without staging gives the same bytes;
the visualizer gives svc_tpu's composites (``.npy`` dumps).
"""

import json
import os
import sys
import threading

import numpy as np
import pytest
import torch

from svc_tpu.config import DecoderConfig as JDecoderConfig
from svc_tpu.config import EncoderConfig as JEncoderConfig
from svc_tpu.config import KMeansParams as JKMeansParams
from svc_tpu.config import VideoProperties as JVideoProperties
from svc_tpu.io import bitstream as j_bitstream
from svc_tpu.models.decoder import Decoder as JDecoder
from svc_tpu.models.encoder import Encoder as JEncoder
from svc_tpu.runtime.tracing import Tracer as JTracer
from svc_tpu import visualize as jvis
from svc_tpu_torch import visualize as tvis
from svc_tpu_torch.config import DecoderConfig, EncoderConfig, KMeansParams, VideoProperties
from svc_tpu_torch.io import bitstream
from svc_tpu_torch.models.decoder import Decoder
from svc_tpu_torch.models.encoder import Encoder, stream_encode
from svc_tpu_torch.runtime import pipeline, staging, tracing
from svc_tpu_torch.tools.clips import make_clip

COEFF_GATE = 2.5e-4
W, H, BATCH = 64, 48, 4
DEC_BATCH = 3


# ---------------------------------------------------------------- stager


def test_stager_orders_and_rejects_double_submit():
    with staging.DoubleBufferedStager(lambda x: ("dev", x)) as s:
        s.submit(1)
        assert s.has_pending
        with pytest.raises(RuntimeError):
            s.submit(2)
        assert s.collect() == ("dev", 1)
        with pytest.raises(RuntimeError):
            s.collect()
        s.submit(2)
        assert s.collect() == ("dev", 2)
        assert not s.has_pending


def test_stager_collect_without_submit_raises():
    with staging.DoubleBufferedStager(lambda x: x) as s:
        with pytest.raises(RuntimeError, match="no staged batch pending"):
            s.collect()


def test_stager_propagates_stage_errors():
    def boom(x):
        raise ValueError("transfer failed")

    with staging.DoubleBufferedStager(boom) as s:
        s.submit(1)
        with pytest.raises(ValueError, match="transfer failed"):
            s.collect()


def test_stager_runs_on_one_worker_thread():
    with staging.DoubleBufferedStager(lambda x: threading.get_ident()) as s:
        idents = set()
        for i in range(4):
            s.submit(i)
            idents.add(s.collect())
    assert len(idents) == 1 and threading.get_ident() not in idents


def test_cpu_upload_stacks_frames_and_packed_rows():
    up = staging.PinnedUpload(torch.device("cpu"))
    frames = [np.full((2, 3, 3), i, np.uint8) for i in range(4)]
    a = up(frames, (4, 2, 9), torch.uint8)
    b = up(np.stack(frames).reshape(4, 2, 9), (4, 2, 9), torch.uint8)
    assert a.event is None and a.take().shape == (4, 2, 9)
    assert torch.equal(a.take(), b.take())
    assert torch.equal(a.take()[3], torch.full((2, 9), 3, dtype=torch.uint8))


# -------------------------------------------------------------- pipeline


def test_producer_exception_propagates():
    def bad_producer(q):
        q.push(1)
        raise RuntimeError("reader exploded")

    seen = []

    def consumer(q):
        for item in q:
            seen.append(item)

    with pytest.raises(RuntimeError, match="reader exploded"):
        pipeline.pipeline_threads(bad_producer, consumer, capacity=2)
    assert seen == [1]


def test_cancelled_consumer_unblocks_full_queue_producer():
    cancel = pipeline.CancelToken()
    pushed = []

    def producer(q):
        for i in range(1000):  # far more than the queue holds
            cancel.check()
            q.push(i)
            pushed.append(i)

    def consumer(q):
        q.pop()
        raise pipeline.CancelledError("consumer quits")

    result = {}

    def run():
        pipeline.pipeline_threads(producer, consumer, capacity=2, cancel=cancel)
        result["done"] = True

    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(timeout=30)
    assert not t.is_alive() and result == {"done": True}
    assert cancel.cancelled and len(pushed) < 1000


def test_bounded_queue_pops_none_only_after_done():
    q = pipeline.BoundedQueue(4)
    q.push("a")
    q.signal_producer_done()
    assert q.pop() == "a"
    assert q.pop() is None and q.pop() is None  # the sentinel stays
    assert list(q) == []


def test_cancel_token():
    tok = pipeline.CancelToken()
    tok.check()
    assert not tok.wait(0.0)
    tok.cancel()
    assert tok.cancelled and tok.wait(0.0)
    with pytest.raises(pipeline.CancelledError):
        tok.check()


# ---------------------------------------------------------------- tracer


class TestTracer:
    # svc_tpu's TestTracer (tests/test_resume_tracing.py:128-195)
    def test_spans_and_stats(self):
        tr = tracing.Tracer()
        with tr.span("a"):
            pass
        with tr.span("a"):
            pass
        with tr.span("b", frames=4):
            pass
        stats = tr.stats()
        assert stats["a"]["count"] == 2
        assert stats["b"]["count"] == 1
        assert "mean_s" in stats["a"]
        assert "a" in tr.report()
        assert tr.events[-1]["frames"] == 4

    def test_disabled_records_nothing(self):
        tr = tracing.Tracer(enabled=False)
        with tr.span("x"):
            pass
        assert tr.events == []

    def test_dump(self, tmp_path):
        tr = tracing.Tracer()
        with tr.span("stage"):
            pass
        path = str(tmp_path / "trace.json")
        tr.dump(path)
        with open(path) as f:
            data = json.load(f)
        assert data["stats"]["stage"]["count"] == 1

    def test_stats_keys_equal_svc_tpu(self):
        ours, ref = tracing.Tracer(), JTracer()
        for tr in (ours, ref):
            with tr.span("x"):
                pass
        assert set(ours.stats()["x"]) == set(ref.stats()["x"])
        assert ours.report().split()[:2] == ref.report().split()[:2]


def test_device_profile_without_dir_records_nothing(tmp_path):
    with tracing.device_profile(None):
        torch.ones(3).sum()
    with tracing.device_profile("", "cpu"):
        pass
    assert os.listdir(tmp_path) == []


def test_device_profile_writes_a_cpu_trace(tmp_path):
    out = tmp_path / "prof"
    with tracing.device_profile(str(out), "cpu"):
        (torch.ones(64, 64) @ torch.ones(64, 64)).sum()
    with open(out / tracing.TRACE_FILE) as f:
        trace = json.load(f)
    assert any("mm" in e.get("name", "") for e in trace["traceEvents"])


# --------------------------------------------- streams against svc_tpu


def _run_encode(enc, clip):
    """One streamed encode, recording its spans and on_batch calls."""
    tr, calls = (JTracer() if isinstance(enc, JEncoder) else tracing.Tracer()), []
    stream = list(enc.encode_video(
        iter(clip), tracer=tr,
        on_batch=lambda fi, out, nv: calls.append((fi, nv, set(out)))))
    return stream, [e["name"] for e in tr.events], calls


@pytest.fixture(scope="module", params=[9, 12], ids=lambda n: f"{n}frames")
def encoded(request):
    n = request.param
    clip = make_clip(W, H, n, seed=n)
    jenc = JEncoder(JEncoderConfig(), JVideoProperties(W, H, n), batch_size=BATCH)
    tenc = Encoder(EncoderConfig(), VideoProperties(W, H, n), batch_size=BATCH,
                   device="cpu")
    js, jspans, jcalls = _run_encode(jenc, clip)
    ts, tspans, tcalls = _run_encode(tenc, clip)
    return dict(n=n, clip=clip, tenc=tenc, js=js, ts=ts, jspans=jspans,
                tspans=tspans, jcalls=jcalls, tcalls=tcalls)


def _direct_payloads(enc, frames):
    """Direct per-batch encode + serialize, no stager, nothing in flight
    (svc_tpu's tests/test_staging.py:56-80)."""
    out_payloads, i, n = [], 0, len(frames)
    t = enc.batch_size
    tbh, tbw = enc.cfg.transform_block_h, enc.cfg.transform_block_w
    while i + 1 < n:
        n_valid = min(t, n - 1 - i)
        window = frames[i:i + n_valid + 1]
        if n_valid < t:  # pad like the stream does
            window = np.concatenate([window, np.repeat(window[-1:], t - n_valid, 0)])
        out = enc.encode_batch(window, i)
        c = out["coeffs"].numpy()
        c = c.reshape(c.shape[0], c.shape[1], c.shape[2], -1, tbh, tbw)
        btypes = out["block_types"].numpy().astype(np.uint32)
        for k in range(n_valid):
            out_payloads.append(bitstream.serialize_frame_blocks(
                c[k], btypes[k], enc.cfg.mv_block_w, enc.cfg.mv_block_h))
        i += n_valid
    return out_payloads


def test_staged_stream_matches_direct_batches(encoded):
    enc, ts = encoded["tenc"], encoded["ts"]
    assert ts[0] == enc.header().pack()
    assert len(ts) == encoded["n"]
    assert ts[1:] == _direct_payloads(enc, encoded["clip"])


def test_stream_matches_svc_tpu(encoded):
    js, ts = encoded["js"], encoded["ts"]
    assert ts[0] == js[0] and len(ts) == len(js)
    header = bitstream.Header.unpack(ts[0])
    fg = 0
    for jp, tp in zip(js[1:], ts[1:]):
        jt, jc = bitstream.deserialize_frame_blocks(jp, header)
        tt, tc = bitstream.deserialize_frame_blocks(tp, header)
        np.testing.assert_array_equal(tt, jt)
        assert np.abs(tc - jc).max() <= COEFF_GATE
        fg += int((tt > 0).sum())
    assert fg > 0


def test_encode_span_sequence_equals_svc_tpu(encoded):
    spans = encoded["tspans"]
    assert spans == encoded["jspans"]
    assert spans.count("serialize") == encoded["n"] - 1
    # one batch in flight: the second dispatch precedes the first fetch
    assert spans.index("device_fetch") > 1 and spans[:2] == ["device_dispatch"] * 2


def test_on_batch_calls_equal_svc_tpu(encoded):
    ours = [(fi, nv) for fi, nv, _ in encoded["tcalls"]]
    assert ours == [(fi, nv) for fi, nv, _ in encoded["jcalls"]]
    assert sum(nv for _, nv in ours) == encoded["n"] - 1
    # the port's outputs carry svc_tpu's keys
    assert encoded["tcalls"][0][2] == encoded["jcalls"][0][2]


def test_stream_resumes_from_an_anchor_index(encoded):
    enc, clip, ts = encoded["tenc"], encoded["clip"], encoded["ts"]
    tail = list(stream_encode(enc, iter(clip[2:]), emit_header=False,
                              first_anchor_index=2))
    assert tail == ts[3:]


def test_stream_unstaged_encoder_protocol(encoded):
    # an encoder without the staged protocol dispatches directly (the
    # wrapper exposes only header / batch_size / cfg / encode_batch)
    class Direct:
        def __init__(self, enc):
            self.cfg, self.batch_size = enc.cfg, enc.batch_size
            self.header, self.encode_batch = enc.header, enc.encode_batch

    assert list(stream_encode(Direct(encoded["tenc"]), iter(encoded["clip"]))) == encoded["ts"]


# ---------------------------------------------------------------- decode


@pytest.fixture(scope="module")
def decoded(encoded):
    """svc_tpu's stream decoded by both packages (batch 3: a padded last batch)."""
    js = encoded["js"]
    header = bitstream.Header.unpack(js[0])
    gazes = [(W // 2, H // 2)] * (len(js) - 1)
    jdec = JDecoder(JDecoderConfig(), j_bitstream.Header.unpack(js[0]),
                    batch_size=DEC_BATCH)
    jtr, ttr = JTracer(), tracing.Tracer()
    want = np.stack(list(jdec.decode_frames(iter(js[1:]), iter(gazes), tracer=jtr)))
    dec = Decoder(DecoderConfig(), header, batch_size=DEC_BATCH, device="cpu")
    got = np.stack(list(dec.decode_frames(iter(js[1:]), iter(gazes), tracer=ttr)))
    plain = np.stack(list(dec.decode_frames(iter(js[1:]), iter(gazes), stage_h2d=False)))
    return dict(want=want, got=got, plain=plain,
                jspans=[e["name"] for e in jtr.events],
                tspans=[e["name"] for e in ttr.events])


def test_decode_staged_equals_unstaged(decoded):
    np.testing.assert_array_equal(decoded["got"], decoded["plain"])


def test_decode_matches_svc_tpu(decoded):
    got, want = decoded["got"], decoded["want"]
    assert got.shape == want.shape == (len(got), H, W, 3)
    diff = np.abs(got.astype(np.int16) - want.astype(np.int16))
    assert diff.max() <= 1 and (diff > 0).mean() < 1e-3


def test_decode_span_sequence_equals_svc_tpu(decoded):
    spans = decoded["tspans"]
    assert spans == decoded["jspans"]
    last_dispatch = len(spans) - 1 - spans[::-1].index("device_dispatch")
    assert spans.count("device_dispatch") >= 3
    assert spans.index("device_fetch") < last_dispatch
    # the second dispatch comes before the first fetch
    dispatches = [i for i, s in enumerate(spans) if s == "device_dispatch"]
    assert dispatches[1] < spans.index("device_fetch")


# ------------------------------------------------------------ visualizer


def _vis_cfgs():
    kw = dict(mv_block_w=8, mv_block_h=8, mv_search_range=4, pyr_lvl_count=2)
    return (JEncoderConfig(**kw, kmeans=JKMeansParams(cluster_count=3)),
            EncoderConfig(**kw, kmeans=KMeansParams(cluster_count=3)))


def _vis_frames():
    # svc_tpu's tests/test_visualize.py clip
    rng = np.random.default_rng(1)
    coarse = rng.integers(30, 220, (24, 28)).astype(np.float32)
    bg = np.kron(coarse, np.ones((4, 4)))
    return np.stack([
        np.repeat(bg[8 + t:56 + t, 4 + t:68 + t, None], 3, -1).astype(np.uint8)
        for t in range(4)])


def test_keep_planes_equals_svc_tpu():
    frames = _vis_frames()
    jcfg, tcfg = _vis_cfgs()
    jout = JEncoder(jcfg, JVideoProperties(64, 48, 4), batch_size=3,
                    keep_planes=True).encode_batch(frames, 0)
    tenc = Encoder(tcfg, VideoProperties(64, 48, 4), batch_size=3, device="cpu",
                   keep_planes=True)
    tout = tenc.encode_batch(frames, 0)
    assert tuple(tout["padded_planes"].shape) == (3, 4, 48, 64)
    np.testing.assert_array_equal(tout["padded_planes"].numpy(),
                                  np.asarray(jout["padded_planes"]))
    assert "padded_planes" not in Encoder(
        tcfg, VideoProperties(64, 48, 4), batch_size=3, device="cpu"
    ).encode_batch(frames, 0)


def test_visualizing_encoder_dumps_equal_svc_tpu(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "cv2", None)  # .npy dumps, no titles
    frames = _vis_frames()
    jcfg, tcfg = _vis_cfgs()
    jdir, tdir = str(tmp_path / "j"), str(tmp_path / "t")
    jenc = JEncoder(jcfg, JVideoProperties(64, 48, 4), batch_size=3, keep_planes=True)
    tenc = Encoder(tcfg, VideoProperties(64, 48, 4), batch_size=3, device="cpu",
                   keep_planes=True)
    jchunks = list(jvis.VisualizingEncoder(jenc, jdir).encode_video(iter(frames)))
    tchunks = list(tvis.VisualizingEncoder(tenc, tdir).encode_video(iter(frames)))
    assert len(tchunks) == len(jchunks) == 4  # header + 3 payloads
    names = sorted(os.listdir(tdir))
    assert names == sorted(os.listdir(jdir)) == [f"frame_{i:05d}.npy" for i in range(3)]
    for name in names:
        np.testing.assert_array_equal(np.load(os.path.join(tdir, name)),
                                      np.load(os.path.join(jdir, name)))


def test_visualizer_requires_planes(tmp_path):
    _, tcfg = _vis_cfgs()
    enc = Encoder(tcfg, VideoProperties(64, 48, 4), batch_size=3, device="cpu")
    with pytest.raises(ValueError, match="keep_planes"):
        tvis.VisualizingEncoder(enc, str(tmp_path))


def test_live_view_needs_cv2(monkeypatch):
    monkeypatch.setitem(sys.modules, "cv2", None)
    _, tcfg = _vis_cfgs()
    enc = Encoder(tcfg, VideoProperties(64, 48, 4), batch_size=3, device="cpu",
                  keep_planes=True)
    with pytest.raises(ImportError):
        tvis.LiveEncoderView(enc)


def _compose_cases():
    h, w = 32, 48
    frame = np.random.default_rng(0).integers(0, 256, (h, w, 3)).astype(np.uint8)
    fg = np.zeros((4, 6), bool)
    fg[1, 2] = True
    layout = (frame, np.zeros((4, 6, 2), np.float32), np.zeros(2), fg, fg,
              np.where(fg, 0, -1), np.where(fg, 2, 0).astype(np.uint32))
    fg4 = np.zeros((4, 4), bool)
    arrows = (np.zeros((32, 32, 3), np.uint8), np.full((4, 4, 2), 3.0, np.float32),
              np.asarray([3.0, 1.0]), fg4, fg4, np.full((4, 4), -1),
              np.zeros((4, 4), np.uint32))
    rng = np.random.default_rng(3)
    mixed = (rng.integers(0, 256, (24, 40, 3)).astype(np.uint8),
             rng.integers(-6, 7, (3, 5, 2)).astype(np.float32),
             np.asarray([-0.5, 2.5]), rng.random((3, 5)) < 0.5,
             rng.random((3, 5)) < 0.5, rng.integers(-1, 4, (3, 5)),
             rng.integers(0, 5, (3, 5)).astype(np.uint32))
    return {"layout": layout, "arrows": arrows, "mixed": mixed}


@pytest.mark.parametrize("case", ["layout", "arrows", "mixed"])
def test_compose_views_equals_svc_tpu(case):
    args = _compose_cases()[case]
    got = tvis.compose_views(*args)
    np.testing.assert_array_equal(got, jvis.compose_views(*args))
    h, w = args[0].shape[:2]
    assert got.shape == (3 * h, 3 * w, 3)
    if case == "arrows":
        assert (got[0:h, w:2 * w] == tvis.ARROW_COLOR).all(-1).any()


def test_flow_to_bgr_equals_svc_tpu():
    mv = np.random.default_rng(4).normal(0, 4, (5, 7, 2)).astype(np.float32)
    np.testing.assert_array_equal(tvis.flow_to_bgr(mv), jvis.flow_to_bgr(mv))
    np.testing.assert_array_equal(tvis.flow_to_bgr(mv, 3.0), jvis.flow_to_bgr(mv, 3.0))


def test_arrow_drawing_equals_svc_tpu():
    for args in ((2, 10, 22, 10), (3, 4, 3, 4), (30, 2, 1, 17), (-5, 3, 12, 40)):
        a, b = np.zeros((20, 40, 3), np.uint8), np.zeros((20, 40, 3), np.uint8)
        tvis.draw_arrow(a, *args, color=(1, 2, 3))
        jvis.draw_arrow(b, *args, color=(1, 2, 3))
        np.testing.assert_array_equal(a, b)
    a, b = np.zeros((8, 8, 3), np.uint8), np.zeros((8, 8, 3), np.uint8)
    tvis.draw_motion_vec_as_field(a, np.asarray([-0.5, 0.0], np.float32), 8, 8)
    jvis.draw_motion_vec_as_field(b, np.asarray([-0.5, 0.0], np.float32), 8, 8)
    np.testing.assert_array_equal(a, b)
    assert a[0, 0].any()
