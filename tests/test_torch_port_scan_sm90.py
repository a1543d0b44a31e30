"""The routing and the interface of the Hopper bf16 Mamba-1 scan body
(``csrc/selective_scan_bf16_sm90.cu``), on the CPU: which body each K2, K3
and K4 call takes by activation dtype and d_state; the launch counts the
routes move; the C interface as the wrapper declares it against the source's
own signatures; the copy that gives the tensor memory accelerator aligned
rows, on the perf path's views and on views it cannot read; the h_entries
contract between K3 and K4 (every 8 steps on this body, 16 elsewhere). The
body's arithmetic runs on the card only, where tests/test_torch_port_cuda.py
and chip_smoke.py hold it against the plain versions that
tests/test_torch_port_perf.py holds against the JAX package.
"""

from __future__ import annotations

import contextlib
import ctypes
import re
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from si_mamba_tpu_torch.ops.kernels import selective_scan as ks
from si_mamba_tpu_torch.ops.kernels.build import CSRC, SOURCES

BF, F32 = torch.bfloat16, torch.float32


@pytest.mark.parametrize("dtype,n,serves,tile", [
    (BF, 16, True, 8),      # perf mode: the Hopper body, h_entries every 8 steps
    (F32, 16, False, 16),   # fp32: csrc/selective_scan_{fwd,bwd}.cu
    (BF, 8, False, 16),     # another d_state: csrc/mamba_any.cu
    (BF, 32, False, 16),
    (F32, 8, False, 16),
])
def test_sm90_serves_bf16_at_the_tuned_state(dtype, n, serves, tile):
    assert ks.sm90_serves(dtype, n) == serves
    assert ks.entry_tile(dtype, n) == tile


def test_sm90_counts_and_source():
    """The body's launch counts, one for each of K2, K3 and K4, named after
    the bf16 wrapper with '_sm90' before the dtype; the source is built with
    the others."""
    assert list(ks.SM90_LAUNCHES) == ["selective_scan_fwd_sm90_bf16",
                                      "selective_scan_fwd_residuals_sm90_bf16",
                                      "selective_scan_bwd_sm90_bf16"]
    assert ks.SM90_SOURCE in SOURCES
    assert (CSRC / f"{ks.SM90_SOURCE}.cu").is_file()
    # the fp32 wrappers keep their own counts; the bf16 ones have none now
    for name in ("selective_scan_fwd_bf16", "selective_scan_fwd_residuals_bf16",
                 "selective_scan_bwd_bf16"):
        assert not hasattr(getattr(ks, name), "launches")


def _c_signature(name: str) -> list:
    """The ctypes types of the C entry point ``name``'s parameters, read from
    the source: long long* a POINTER(c_longlong), any other pointer c_void_p,
    int c_int."""
    src = (CSRC / f"{ks.SM90_SOURCE}.cu").read_text()
    m = re.search(rf"\nint {name}\(([^)]*)\)\s*\{{", src)
    assert m, name
    out = []
    for param in m.group(1).split(","):
        param = " ".join(param.split())
        if param.startswith("const long long*"):
            out.append(ctypes.POINTER(ctypes.c_longlong))
        elif "*" in param:
            out.append(ctypes.c_void_p)
        else:
            assert param.startswith("int "), param
            out.append(ctypes.c_int)
    return out


class _Fn:
    """A C entry point that records its calls and returns 0."""

    def __init__(self, log, name, result=0):
        self.log, self.name, self.result = log, name, result

    def __call__(self, *args):
        self.log.append((self.name, args))
        return self.result


@pytest.mark.parametrize("name", list(ks.SM90_ENTRIES))
def test_entry_declarations_match_the_source(name):
    """Every argument of the body's entry points is declared with the C type
    of its parameter: a pointer passed as a 32-bit int would be cut."""
    assert ks.SM90_ENTRIES[name] == _c_signature(name)
    log = []
    lib = SimpleNamespace(**{n: _Fn(log, n) for n in (
        *ks.SM90_ENTRIES, "scan_sm90_segments", "scan_sm90_error_string",
        "scan_sm90_block_channels")}, scan_sm90_entry_tile=_Fn(log, "tile", ks.SM90_TILE))
    ks.sm90_interface(lib)
    assert getattr(lib, name).argtypes == ks.SM90_ENTRIES[name]
    assert getattr(lib, name).restype is ctypes.c_int
    # a source whose h_entries tile is not SM90_TILE is refused
    lib.scan_sm90_entry_tile = _Fn(log, "tile", 16)
    with pytest.raises(RuntimeError, match="kHTile"):
        ks.sm90_interface(lib)


def _perf_views(b=2, l=32, d=64, n=16, dt_rank=24):
    """Perf mode's scan operands as the bf16 mixer makes them: z a column
    view of xz, B and C column views of x_dbl (dt_rank + 2n wide)."""
    xz = torch.zeros(b, l, 2 * d, dtype=BF)
    x_dbl = torch.zeros(b, l, dt_rank + 2 * n, dtype=BF)
    u, dt = torch.zeros(b, l, d, dtype=BF), torch.zeros(b, l, d, dtype=BF)
    return (u, dt, -torch.ones(d, n), x_dbl[..., dt_rank:dt_rank + n],
            x_dbl[..., dt_rank + n:], torch.ones(d), xz[..., d:], torch.zeros(d))


def test_tma_view_takes_the_perf_views_as_they_lie():
    """At the perf shape (d_inner 768, dt_rank 24) z starts 1536 bytes into
    each 3072-byte row of xz, B and C 48 and 80 bytes into x_dbl's 112-byte
    rows: the tensor maps read all of them in place."""
    args = _perf_views(b=2, l=16, d=768)
    for t in (args[0], args[1], args[3], args[4], args[6]):
        assert ks.tma_view(t) is t
    views, strides = ks._tma_operands(args[6], args[3])
    assert views[0] is args[6] and views[1] is args[3]
    assert strides == [16 * 1536, 1536, 16 * 56, 56]


@pytest.mark.parametrize("offset,width,copied", [
    (0, 64, False),   # contiguous rows of 128 bytes
    (3, 64, True),    # 6 bytes in: the start is not 16-byte aligned
    (8, 64, False),   # 16 bytes in, rows of 144 bytes
    (0, 70, True),    # rows of 140 + 16 bytes: 156, not a multiple of 16
])
def test_tma_view_copies_only_rows_it_cannot_read(offset, width, copied):
    """A view the maps cannot read is copied, equal, into rows padded to 16
    bytes; the copy's row stride is the padded width."""
    base = torch.arange(2 * 5 * (width + 8), dtype=F32).to(BF).reshape(2, 5, width + 8)
    t = base[..., offset:offset + width]
    got = ks.tma_view(t)
    assert (got.data_ptr() != t.data_ptr()) == copied
    assert torch.equal(got, t) and ks._tma_ready(got)
    if copied:
        assert got.stride(1) == -(-width // 8) * 8


def test_tma_operands_ignore_the_strides_of_length_one_axes():
    """One cloud, or one step: the stride of an axis of length 1 is never
    followed, so an unaligned one neither forces a copy nor reaches the map."""
    t = torch.zeros(1, 1, 64, dtype=BF).as_strided((1, 1, 64), (3, 5, 1))
    assert ks._tma_ready(t)
    assert ks._tma_operands(t) == ([t], [64, 64])
    h = torch.zeros(1, 1, 16, 6)  # h_entries of one tile, rows of 24 bytes: padded
    assert not ks._tma_ready(h) and ks.tma_view(h).stride(2) == 8



@pytest.mark.parametrize("shape,strides,offset", [
    ((2, 5, 64), (320, 64, 1), 0),  # contiguous
    ((2, 5, 64), (323, 64, 1), 0),  # batch stride of 646 bytes
    ((2, 5, 64), (328, 65, 1), 0),  # row stride of 130 bytes
    ((1, 5, 64), (3, 64, 1), 0),    # one cloud: its stride is never followed
    ((2, 1, 64), (64, 5, 1), 0),    # one step
    ((2, 5, 64), (320, 64, 1), 4),  # the start 8 bytes in
    ((2, 5, 64), (320, 64, 2), 0),  # not unit stride along w
])
def test_tma_operands_copy_exactly_what_tma_view_copies(shape, strides, offset):
    """The wrappers' one-pass check copies a view exactly when
    ``_tma_ready`` refuses it, and hands the maps aligned strides, those of
    the view wherever they are followed."""
    t = torch.arange(1000, dtype=F32).to(BF).as_strided(shape, strides, offset)
    (view,), got = ks._tma_operands(t)
    assert (view is t) == ks._tma_ready(t)
    assert torch.equal(view, t) and ks._tma_ready(view)
    assert all(s % 8 == 0 for s in got)
    nb, nl, _ = view.shape
    assert (nb == 1 or got[0] == view.stride(0)) and (nl == 1 or got[1] == view.stride(1))

@pytest.fixture
def routed(monkeypatch):
    """_launch_fwd / _launch_bwd on CPU tensors with the C side replaced by
    recorders: which entry point of which library each call reached."""
    log = []
    cuda = SimpleNamespace(cuda_stream=0)
    monkeypatch.setattr(ks.torch.cuda, "device", lambda _: contextlib.nullcontext())
    monkeypatch.setattr(ks.torch.cuda, "current_stream", lambda _=None: cuda)
    monkeypatch.setattr(ks, "_check_inputs",
                        lambda t, extra=None: (*t["u"].shape, t["A"].shape[1]))
    fwd = SimpleNamespace(selective_scan_fwd=_Fn(log, "fp32 K2"),
                          selective_scan_fwd_residuals=_Fn(log, "fp32 K3"),
                          selective_scan_fwd_segments=lambda *a: 1,
                          selective_scan_error_string=None)
    bwd = SimpleNamespace(selective_scan_bwd=_Fn(log, "fp32 K4"),
                          selective_scan_bwd_block_channels=lambda: 64,
                          selective_scan_bwd_error_string=None)
    sm90 = SimpleNamespace(scan_sm90_fwd=_Fn(log, "sm90 K2"),
                           scan_sm90_fwd_residuals=_Fn(log, "sm90 K3"),
                           scan_sm90_bwd=_Fn(log, "sm90 K4"),
                           scan_sm90_segments=lambda *a: 2, scan_sm90_block_channels=lambda: 64,
                           scan_sm90_error_string=None)
    monkeypatch.setattr(ks, "_fwd_library", lambda: fwd)
    monkeypatch.setattr(ks, "_bwd_library", lambda: bwd)
    monkeypatch.setattr(ks, "_sm90_library", lambda: sm90)
    return log


def _counts():
    return {**{k: v.launches for k, v in ks.SM90_LAUNCHES.items()},
            **{f.__name__: f.launches for f in (ks.selective_scan_fwd,
                                                ks.selective_scan_fwd_residuals,
                                                ks.selective_scan_bwd)}}


def _moved(before):
    return {k: v - before[k] for k, v in _counts().items() if v != before[k]}


@pytest.mark.parametrize("dtype,residuals,entry,count,tile", [
    (BF, False, "sm90 K2", "selective_scan_fwd_sm90_bf16", 8),
    (BF, True, "sm90 K3", "selective_scan_fwd_residuals_sm90_bf16", 8),
    (F32, False, "fp32 K2", "selective_scan_fwd", 16),
    (F32, True, "fp32 K3", "selective_scan_fwd_residuals", 16),
])
def test_forward_launches_the_body_that_owns_the_dtype(routed, dtype, residuals, entry, count,
                                                       tile):
    """K2 and K3 at bf16 and d_state 16 launch the Hopper body and count on
    its '_sm90' counts, with h_entries every 8 steps and the body's own
    segment count (its scratch sized to it); at fp32 the earlier body runs and
    counts as it did. Nothing else is called."""
    args = _perf_views(b=2, l=40, d=64)
    args = tuple(t.to(dtype) if t.dtype == BF else t for t in args)
    before = _counts()
    y, h = ks._launch_fwd(*args, residuals=residuals)
    assert [name for name, _ in routed] == [entry]
    assert _moved(before) == {count: 1}
    assert y.shape == (2, 40, 64) and y.dtype == dtype
    if residuals:
        assert h.shape == (2, -(-40 // tile), 16, 64) and h.dtype == F32
    call = routed[0][1]
    segments = call[-3]
    assert segments == (2 if dtype == BF else 1)
    h_end = call[11 if residuals else 10]  # the scratch after y (and h_entries)
    assert isinstance(h_end, int)


@pytest.mark.parametrize("dtype,entry,count", [
    (BF, "sm90 K4", "selective_scan_bwd_sm90_bf16"),
    (F32, "fp32 K4", "selective_scan_bwd"),
])
def test_backward_launches_the_body_that_owns_the_dtype(routed, dtype, entry, count):
    """K4 likewise; the Hopper body also gets h_entries' row stride as the
    13th stride."""
    args = _perf_views(b=2, l=40, d=64)
    args = tuple(t.to(dtype) if t.dtype == BF else t for t in args)
    tile = ks.entry_tile(dtype, 16)
    g = torch.zeros(2, 40, 64, dtype=dtype)
    h = torch.zeros(2, -(-40 // tile), 16, 64)
    before = _counts()
    grads = ks._launch_bwd(*args, g, h)
    assert [name for name, _ in routed] == [entry]
    assert _moved(before) == {count: 1}
    strides = routed[0][1][-2]
    assert len(strides) == (13 if dtype == BF else 12)
    if dtype == BF:
        assert strides[12] == 64
    assert [x.dtype for x in grads] == [dtype, dtype, F32, dtype, dtype, F32, dtype, F32]


def test_any_state_keeps_its_body(routed, monkeypatch):
    """bf16 at another d_state stays on the any-state kernels."""
    seen = []
    monkeypatch.setattr(ks, "_run_fwd_any", lambda *a: seen.append("any") or (a[8], a[9]))
    args = _perf_views(b=1, l=16, d=64, n=8)
    ks._launch_fwd(*args, residuals=True)
    assert seen == ["any"] and routed == []


def _scan_case(b=2, l=40, d=12, n=16, seed=0):
    rng = np.random.default_rng(seed)
    r = lambda *s, scale=1.0: torch.from_numpy(  # noqa: E731
        (rng.standard_normal(s) * scale).astype(np.float32))
    args = (r(b, l, d), r(b, l, d), -torch.exp(r(d, n)), r(b, l, n), r(b, l, n), r(d), r(b, l, d),
            r(d, scale=0.1))
    return args, r(b, l, d)


def test_h_entries_contract_between_k3_and_k4():
    """K3 and K4 agree on the tile: the plain forward at tile 8 holds every
    other entry of the tile-16 one and the states between; the plain
    backward from tile-8 entries gives the tile-16 one's gradients (the same
    arithmetic, rebuilt from other anchors); on the CPU the bf16 wrappers
    keep the Hopper body's contract, the fp32 ones the earlier one's."""
    args, g = _scan_case()
    y8, h8 = ks.selective_scan_fwd_residuals_ref(*args, tile=8)
    y16, h16 = ks.selective_scan_fwd_residuals_ref(*args)
    assert torch.equal(y8, y16) and h8.shape[1] == 5 and h16.shape[1] == 3
    assert torch.equal(h8[:, ::2], h16)
    g8 = ks.selective_scan_bwd_ref(*args, g, h8, tile=8)
    g16 = ks.selective_scan_bwd_ref(*args, g, h16)
    for a, c in zip(g8, g16):
        torch.testing.assert_close(a, c, rtol=1e-5, atol=1e-5 * c.abs().max().item())

    bf = tuple(t.to(BF) if t.dim() == 3 else t for t in args)
    y, h = ks.selective_scan_fwd_residuals(*bf)
    assert h.shape == (2, 5, 16, 12)
    assert torch.equal(h, ks.selective_scan_fwd_residuals_ref(*bf, tile=8)[1])
    got = ks.selective_scan_bwd(*bf, g.to(BF), h)
    want = ks.selective_scan_bwd_ref(*bf, g.to(BF), h, tile=8)
    assert all(torch.equal(a, c) for a, c in zip(got, want))
    assert ks.selective_scan_fwd_residuals(*args)[1].shape == (2, 3, 16, 12)


def test_sm90_source_keeps_its_constants_in_step_with_the_wrapper():
    """The constants the wrapper and chip_smoke.py read from the source: the
    h_entries tile, the channels a block, the segment rule's tile."""
    src = (CSRC / f"{ks.SM90_SOURCE}.cu").read_text()
    assert f"constexpr int kHTile = {ks.SM90_TILE};" in src
    assert "constexpr int kChannels = 64;" in src
    assert "constexpr int kFwdTile = 16;" in src
    # the earlier sources no longer hold bf16 entry points
    for name in ("selective_scan_fwd", "selective_scan_bwd"):
        assert "_bf16(" not in (CSRC / f"{name}.cu").read_text()


def test_phase_stamps_match_the_trace_script():
    """The body's SCAN_STAMP hooks, empty unless built with
    -DSCAN_PHASE_TRACE, are the slots scripts/torch_scan_phase_trace.py
    reads: one a phase of each forward and backward tile, in order."""
    src = (CSRC / f"{ks.SM90_SOURCE}.cu").read_text()
    slots = re.findall(r"SCAN_STAMP\(((?:2048 \+ )?)8 \* i(?: \+ (\d))?\);", src)
    fwd = [int(k or 0) for base, k in slots if not base]
    bwd = [int(k or 0) for base, k in slots if base]
    text = (CSRC.parents[1] / "scripts" / "torch_scan_phase_trace.py").read_text()
    names = {key: len(re.search(key + r' = \(([^)]*)\)', text).group(1).split(","))
             for key in ("FWD", "BWD")}
    assert fwd == list(range(names["FWD"])) and bwd == list(range(names["BWD"]))
    assert re.search(r"#ifdef SCAN_PHASE_TRACE\n.*#define SCAN_STAMP\(slot\) scan_stamp\(slot\)\n"
                     r"#else\n#define SCAN_STAMP\(slot\) \(\(void\)0\)\n#endif", src, re.S)
