"""The compiled decode batch on the CPU.

On the CPU ``Decoder(graph=True)`` never touches ``GraphPair`` or
``torch.cuda.CUDAGraph`` and decodes svc_tpu's frames. The program a
graph captures issues no host copy and no host read once warmed up (run
on a meta device, which stands in for the card). The in-place inputs of
``GraphPair`` and ``PinnedUpload`` run here against stand-ins for the
CUDA runtime (streams, events, graphs) that log each wait and replay:
each batch is written into the static input of its call's parity, each
upload waits on the event recorded after the replay two calls back, and
the padded remainder batch takes the same graphs.
"""

import contextlib
import itertools

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from svc_tpu.config import DecoderConfig as JDecoderConfig
from svc_tpu.io import bitstream as j_bitstream
from svc_tpu.models.decoder import Decoder as JDecoder
from svc_tpu_torch.config import DecoderConfig
from svc_tpu_torch.io import bitstream
from svc_tpu_torch.models import decoder as decoder_mod
from svc_tpu_torch.models.decoder import Decoder
from svc_tpu_torch.ops import dct
from svc_tpu_torch.runtime import graphs, staging


def _payloads(w, h, ew, eh, n, seed, block=8):
    """A header and ``n`` wire payloads of seeded coefficients and block
    types (the transform grid as the MV field)."""
    header = bitstream.Header(n, w, h, ew, eh, block, block, 3)
    nby, nbx = header.padded_frame_h // block, header.padded_frame_w // block
    rng = np.random.default_rng(seed)
    payloads = []
    for _ in range(n):
        coeffs = (rng.normal(size=(nby, nbx, 3, block, block)) * 90).astype(np.float32)
        types = rng.integers(0, 3, (nby, nbx)).astype(np.uint32)
        payloads.append(bitstream.serialize_frame_blocks(coeffs, types, block, block))
    gazes = [(int(rng.integers(0, w)), int(rng.integers(0, h))) for _ in range(n)]
    return header, payloads, gazes


def _display_gate(a, b):
    assert a.shape == b.shape and a.dtype == b.dtype == np.uint8
    d = np.abs(a.astype(np.int16) - b.astype(np.int16))
    assert d.max() <= 1 and (d > 0).mean() < 1e-3


class _NoGraph:
    def __init__(self, *a, **k):
        raise AssertionError("a CPU decoder touched a CUDA graph")


# (w, h, excess w, excess h, batch, devices): the width-aligned route (K1's
# plain version, rows resampled), width excess (K6's), and a device list;
# 7 payloads end in a padded remainder batch
CPU_CASES = [(64, 40, 0, 8, 3, None), (120, 64, 8, 0, 3, None),
             (64, 40, 0, 8, 4, ["cpu", "cpu"])]


@pytest.mark.parametrize("w,h,ew,eh,batch,devices", CPU_CASES)
def test_cpu_decoder_never_captures_and_matches_svc_tpu(monkeypatch, w, h, ew,
                                                        eh, batch, devices):
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _NoGraph)
    monkeypatch.setattr(decoder_mod, "GraphPair", _NoGraph)
    header, payloads, gazes = _payloads(w, h, ew, eh, 7, seed=w + h)
    dec = Decoder(DecoderConfig(), header, batch_size=batch, device="cpu",
                  devices=devices, graph=True)
    assert dec.graph is False
    staged = np.stack(list(dec.decode_frames(iter(payloads), iter(gazes))))
    direct = np.stack(list(dec.decode_frames(iter(payloads), iter(gazes),
                                             stage_h2d=False)))
    assert not dec._graphs
    np.testing.assert_array_equal(staged, direct)
    jdec = JDecoder(JDecoderConfig(), j_bitstream.Header.unpack(header.pack()),
                    batch_size=batch)
    want = np.stack(list(jdec.decode_frames(iter(payloads), iter(gazes))))
    assert staged.shape == (7, h, w, 3)
    _display_gate(staged, want)


# ---------------------------------------------------------------------------
# The captured program: nothing on the host once warmed up
# ---------------------------------------------------------------------------


class _HostTraffic(TorchDispatchMode):
    """Record every operation that takes a CPU tensor or reads a value back
    to the host."""

    def __init__(self):
        super().__init__()
        self.found = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        leaves = torch.utils._pytree.tree_leaves((args, kwargs))
        if any(isinstance(a, torch.Tensor) and a.device.type == "cpu"
               for a in leaves) or func is torch.ops.aten._local_scalar_dense.default:
            self.found.append(str(func))
        return func(*args, **kwargs)


@pytest.mark.parametrize("w,h,ew,eh,block,kernel", [
    (64, 40, 0, 8, 8, "idct_display"),
    (120, 64, 8, 0, 8, "idct_resize_display"),
    (64, 40, 0, 8, 4, "idct4x4_display"),
    (64, 40, 0, 8, 16, "idct16x16_display"),
    (64, 40, 0, 8, 2, "idct2x2_display"),
    (48, 40, 0, 8, 3, "idct_display_general"),
    (64, 40, 0, 8, 1, "idct1x1_display"),
    (120, 64, 8, 0, 4, "idct4x4_resize_display"),
    (120, 64, 8, 0, 16, "idct16x16_resize_display"),
])
def test_captured_program_does_no_host_work_after_its_warm_up(
        monkeypatch, w, h, ew, eh, block, kernel):
    launched = []
    monkeypatch.setattr(decoder_mod, "resolve_device", lambda d: torch.device("meta"))
    monkeypatch.setattr(dct, "_check_cuda", lambda name, t: None)
    monkeypatch.setattr(dct, "stream_handle", lambda t: 0)
    monkeypatch.setattr(dct, "_sm_count", lambda dev: 132)
    monkeypatch.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())
    for k in (dct.IDCT_DISPLAY, dct.IDCT_DISPLAY_GENERAL, dct.IDCT_RESIZE,
              dct.IDCT_RESIZE_GENERAL, *dct.IDCT_DISPLAY_SQ.values(),
              *dct.IDCT_RESIZE_SQ.values()):
        monkeypatch.setattr(k, "launch", lambda *a, _k=k: launched.append(_k.name))
    header = bitstream.Header(2, w, h, ew, eh, block, block, 3)
    dec = Decoder(DecoderConfig(), header, batch_size=2, device="cuda")
    nby, nbx, per_block = dec._wire_shape
    inputs = (torch.zeros((2, nby, nbx, per_block), device="meta"),
              torch.zeros((2, nby, nbx), dtype=torch.int64, device="meta"),
              torch.zeros((2, 4), dtype=torch.int64, device="meta"))
    dec._decode(*inputs)  # the warm-up: fills the table caches
    mode = _HostTraffic()
    with mode:
        out = dec._decode(*inputs)["rows"]
    assert mode.found == []
    assert launched == [kernel, kernel]
    assert out.device.type == "meta" and tuple(out.shape) == (2, h, w * 3)


# ---------------------------------------------------------------------------
# In-place inputs through stand-ins for the CUDA runtime
# ---------------------------------------------------------------------------


class _Stream:
    def __init__(self, name):
        self.name, self.ops = name, []

    def wait_stream(self, other):
        self.ops.append(("wait_stream", other.name))

    def wait_event(self, event):
        self.ops.append(("wait", event.label))


class _Event:
    def record(self, stream):
        # what the event follows: the last operation queued on the stream
        self.label = stream.ops[-1] if stream.ops else None

    def synchronize(self):
        pass


class _Graph:
    """Replays run the captured function again on the captured inputs."""

    capturing = []

    def __init__(self):
        self.captured, self.replays = None, 0

    def replay(self):
        fn, inputs, out = self.captured
        for name, t in fn(*inputs).items():
            out[name].copy_(t)
        _FakeCuda.compute.ops.append(("replay", id(self), self.replays))
        self.replays += 1


def _capturable(fn):
    def run(*inputs):
        out = fn(*inputs)
        if _Graph.capturing:
            _Graph.capturing[-1].captured = (fn, inputs, out)
        return out
    return run


class _FakeCuda:
    compute = _Stream("compute")
    Event = _Event
    CUDAGraph = _Graph

    @staticmethod
    def Stream(device=None):
        return _Stream(f"side{next(_FakeCuda._n)}")

    _n = itertools.count()

    @staticmethod
    def current_stream(device=None):
        return _FakeCuda.compute

    @staticmethod
    def device(d):
        return contextlib.nullcontext()

    @staticmethod
    def stream(s):
        return contextlib.nullcontext()

    @staticmethod
    @contextlib.contextmanager
    def graph(graph, stream=None, capture_error_mode=None):
        _Graph.capturing.append(graph)
        try:
            yield
        finally:
            _Graph.capturing.pop()


class _Torch:
    """``torch`` for the runtime modules: the CUDA stand-ins, and host
    memory for pinned and device allocations."""

    cuda = _FakeCuda

    def __getattr__(self, name):
        return getattr(torch, name)

    @staticmethod
    def empty(*shape, pin_memory=False, device=None, **kw):
        return torch.empty(*shape, **kw)


@pytest.fixture
def fake_cuda(monkeypatch):
    """The runtime modules on the stand-ins; every ``record_stream`` and
    every copy into a tensor logged as ``(op, destination pointer)``."""
    monkeypatch.setattr(graphs, "torch", _Torch())
    monkeypatch.setattr(staging, "torch", _Torch())
    monkeypatch.setattr(staging, "resolve_device", lambda d: d)
    monkeypatch.setattr(_FakeCuda, "compute", _Stream("compute"))
    log = []
    copy = torch.Tensor.copy_

    def logged_copy(self, src, non_blocking=False):
        log.append(("copy", self.data_ptr()))
        return copy(self, src, non_blocking)

    monkeypatch.setattr(torch.Tensor, "copy_", logged_copy)
    monkeypatch.setattr(torch.Tensor, "record_stream",
                        lambda self, s: log.append(("record", self.data_ptr(), s.name)))
    return log


def _double_plus(x, a):
    return {"y": x * 2 + a[:, None]}


def test_claims_write_each_parity_after_the_replay_two_calls_back(fake_cuda):
    # decode_frames' order: batch j is staged (claimed, uploaded) before
    # batch j - 1 replays; the last batch repeats its last row (the padded
    # remainder, same shape)
    pair = graphs.GraphPair(_capturable(_double_plus),
                            [torch.zeros(2, 3), torch.zeros(2)], "cuda:0")
    up = staging.PinnedUpload(torch.device("cuda", 0))
    batches = [np.full((2, 3), j + 1, np.float32) for j in range(5)]
    batches[-1][1] = batches[-1][0]
    aux = [torch.tensor([10.0 * j, -1.0]) for j in range(5)]
    claims, staged, outs = [], [], []

    def stage(j):
        c = pair.claim()
        claims.append(c)
        staged.append(up(batches[j], (2, 3), torch.float32, into=c.inputs[0],
                         after=c.last_read))

    stage(0)
    for j in range(1, 6):
        if j < 5:
            stage(j)
        outs.append({k: v.clone() for k, v in
                     pair(staged[j - 1].take(), aux[j - 1]).items()})
    for j, c in enumerate(claims):
        assert c.call == j and c.inputs is pair._slots[j % 2].inputs
        assert staged[j].tensor is c.inputs[0]
        np.testing.assert_array_equal(outs[j]["y"].numpy(),
                                      batches[j] * 2 + aux[j].numpy()[:, None])
    # the copy stream waited, before each upload from the third on, on the
    # event recorded right after the replay two calls back
    waits = [op[1] for op in up._stream.ops if op[0] == "wait"]
    assert waits == [("replay", id(pair._slots[j % 2].graph), (j - 2) // 2)
                     for j in range(2, 5)]
    # the replays alternate by parity, three of the first graph
    assert [g.graph.replays for g in pair._slots] == [3, 2]
    # each claimed input is written once a batch, by the upload's copy (no
    # static copy of it), and recorded on the copy stream
    for parity, n in ((0, 3), (1, 2)):
        ptr = pair._slots[parity].inputs[0].data_ptr()
        assert fake_cuda.count(("copy", ptr)) == n
        assert ("record", ptr, up._stream.name) in fake_cuda
    # the second input is copied into the static input on every call
    for parity, n in ((0, 3), (1, 2)):
        assert fake_cuda.count(("copy", pair._slots[parity].inputs[1].data_ptr())) == n


def test_claims_are_checked(fake_cuda):
    pair = graphs.GraphPair(_capturable(_double_plus),
                            [torch.zeros(2, 3), torch.zeros(2)], "cuda:0")
    a = torch.ones(2)
    c0 = pair.claim()
    with pytest.raises(RuntimeError, match="claimed but were not passed"):
        pair(torch.ones(2, 3), a)
    c1 = pair.claim()
    with pytest.raises(RuntimeError, match="at most one call"):
        pair.claim()
    with pytest.raises(ValueError, match="static inputs of call 1"):
        pair(c1.inputs[0], a)
    pair(c0.inputs[0], a)
    pair(c1.inputs[0], a)
    with pytest.raises(RuntimeError, match="without a claim"):
        pair(pair._slots[0].inputs[0], a)
    # a direct call copies; a claim dropped by release leaves none behind
    pair(torch.ones(2, 3), a)
    assert pair.claim().call == 3
    pair.release()
    pair(torch.ones(2, 3), a)
    assert pair.claim().call == 4 and pair.claim().call == 5


def test_upload_into_checks_the_tensor(fake_cuda):
    up = staging.PinnedUpload(torch.device("cuda", 0))
    with pytest.raises(ValueError, match="into"):
        up(np.zeros((2, 3), np.float32), (2, 3), torch.float32,
           into=torch.zeros(3, 2))
    with pytest.raises(ValueError, match="into"):
        up(np.zeros((2, 3), np.float32), (2, 3), torch.float32,
           into=torch.zeros((2, 3), dtype=torch.float64))


class _StubPair(graphs.GraphPair):
    """The decoder's graphs on the stand-ins."""

    made = []

    def __init__(self, fn, example_inputs, device):
        super().__init__(_capturable(fn), example_inputs, device)
        _StubPair.made.append(self)


@pytest.mark.parametrize("devices", [None, ["cpu", "cpu"]])
def test_decoder_stages_into_the_graphs_static_inputs(fake_cuda, monkeypatch,
                                                      devices):
    # the decoder's graph path, driven on CPU tensors through the stand-ins:
    # three batches of 3 (4 with a device list), the last a padded
    # remainder; frames equal the eager decode; a stream abandoned with a
    # batch staged and never decoded leaves no claim behind
    monkeypatch.setattr(decoder_mod, "GraphPair", _StubPair)
    monkeypatch.setattr(_StubPair, "made", [])
    batch = 3 if devices is None else 4
    header, payloads, gazes = _payloads(64, 40, 0, 8, 3 * batch - 1, seed=11)
    eager = Decoder(DecoderConfig(), header, batch_size=batch, device="cpu",
                    devices=devices)
    want = np.stack(list(eager.decode_frames(iter(payloads), iter(gazes))))
    dec = Decoder(DecoderConfig(), header, batch_size=batch, device="cpu",
                  devices=devices)
    dec.graph = True  # the stand-ins take the card's place
    claims = []
    claim = graphs.GraphPair.claim
    monkeypatch.setattr(graphs.GraphPair, "claim",
                        lambda self: claims.append((self, claim(self))) or claims[-1][1])
    got = np.stack(list(dec.decode_frames(iter(payloads), iter(gazes))))
    np.testing.assert_array_equal(got, want)
    n_entries = 1 if devices is None else 2
    per = batch // n_entries
    assert sorted(dec._graphs) == [(e, per) for e in range(n_entries)]
    assert len(_StubPair.made) == n_entries  # captured once, before staging
    for entry, pair in enumerate(_StubPair.made):
        mine = [c for p, c in claims if p is pair]
        # 3 batches (the last padded), each into its call's parity
        assert [c.call for c in mine] == [0, 1, 2]
        assert all(c.inputs is pair._slots[c.call % 2].inputs for c in mine)
        assert [s.graph.replays for s in pair._slots] == [2, 1]
    direct = np.stack(list(dec.decode_frames(iter(payloads), iter(gazes),
                                             stage_h2d=False)))
    np.testing.assert_array_equal(direct, want)
    frames = dec.decode_frames(iter(payloads), iter(gazes))
    next(frames)  # batches 0 and 1 replayed, batch 2 staged
    frames.close()
    for pair in _StubPair.made:
        assert pair._claimed == pair._calls
    again = np.stack(list(dec.decode_frames(iter(payloads), iter(gazes))))
    np.testing.assert_array_equal(again, want)
    assert len(_StubPair.made) == n_entries
