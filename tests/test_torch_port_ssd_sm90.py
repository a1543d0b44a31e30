"""The routing and the interface of the Hopper bf16 K8/K9 body
(``csrc/ssd_xbc_bf16_sm90.cu``), on the CPU: which body each K8/K9 entry point
takes by activation dtype, chunk, d_state and head_dim, with or without h_fin
or a seed; the launch counts the routes move; the C interface as the wrappers
declare it against the source's own signatures; the scratch the backward
carves; the copy that gives the tensor memory accelerator aligned rows. The body's arithmetic runs on the card only, where
tests/test_torch_port_cuda.py and chip_smoke.py hold it against the plain
versions that tests/test_torch_port_ssd_bf16.py holds against the JAX package.
"""

from __future__ import annotations

import ctypes
import re
from types import SimpleNamespace

import pytest
import torch

from si_mamba_tpu_torch.ops.kernels import ssd as kssd
from si_mamba_tpu_torch.ops.kernels.build import CSRC, SOURCES

BF, F32 = torch.bfloat16, torch.float32


@pytest.mark.parametrize("dtype,chunk,n,p,want", [
    (BF, 64, 128, 128, "_sm90"),
    (BF, 128, 128, 128, "_sm90"),
    (BF, 192, 128, 128, "_sm90"),
    (BF, 256, 128, 128, "_sm90"),
    (F32, 256, 128, 128, ""),        # fp32: the chunk-parallel body
    (F32, 128, 128, 128, ""),
    (BF, 32, 128, 128, "_strip"),    # no multiple of 64: laid out in strips
    (BF, 96, 128, 128, "_strip"),
    (BF, 512, 128, 128, "_long"),    # above 256
    (BF, 256, 256, 128, "_wide"),    # another d_state or head_dim
    (BF, 256, 128, 256, "_wide"),
    (BF, 512, 256, 256, "_long_wide"),
    (None, 256, 128, 128, ""),       # K6/K7 pass no dtype
])
def test_kernel_variant_routes_by_dtype_chunk_state_and_carry(dtype, chunk, n, p, want):
    """The variant by dtype, chunk and state: the same with or without a
    carry, which the Hopper body takes as the others do."""
    assert kssd.kernel_variant(chunk, n, p, dtype) == want
    assert kssd.sm90_serves(dtype, chunk, n, p) == (want == "_sm90")


def test_sm90_counts_are_variants_of_the_bf16_wrappers():
    """The body's launch counts: one for each bf16 K8 (lean, with states,
    with h_fin, with both) and K9 (from 0, seeded), named after the bf16
    wrapper with '_sm90' before the dtype."""
    names = [k for k in kssd.VARIANT_LAUNCHES if "_sm90" in k]
    assert names == ["ssd_xbc_fwd_sm90_bf16", "ssd_xbc_fwd_hfin_sm90_bf16",
                     "ssd_xbc_fwd_states_sm90_bf16", "ssd_xbc_fwd_states_hfin_sm90_bf16",
                     "ssd_xbc_bwd_sm90_bf16", "ssd_xbc_bwd_seeded_sm90_bf16"]
    assert kssd._variant_name("ssd_xbc_bwd_bf16", "_sm90") == "ssd_xbc_bwd_sm90_bf16"
    assert kssd.SM90_SOURCE in SOURCES
    assert (CSRC / f"{kssd.SM90_SOURCE}.cu").is_file()


def _c_signature(name: str) -> list:
    """The ctypes types of the C entry point ``name``'s parameters, read from
    the source: pointers c_void_p, long long c_longlong, int c_int."""
    src = (CSRC / f"{kssd.SM90_SOURCE}.cu").read_text()
    m = re.search(rf"\n\w[\w\s\*]*\b{name}\(([^)]*)\)\s*\{{", src)
    assert m, name
    out = []
    for param in m.group(1).split(","):
        param = " ".join(param.split())
        if "*" in param:
            out.append(ctypes.c_void_p)
        elif param.startswith("long long"):
            out.append(ctypes.c_longlong)
        else:
            assert param.startswith("int "), param
            out.append(ctypes.c_int)
    return out


@pytest.mark.parametrize("name", ["ssd_sm90_fwd", "ssd_sm90_bwd"])
def test_entry_declarations_match_the_source(name):
    """Every argument of the Hopper body's entry points is declared with the
    C type of its parameter: a pointer or a long long passed as a 32-bit int
    would be cut."""
    assert kssd.SM90_ENTRIES[name] == _c_signature(name)
    lib = SimpleNamespace(**{n: SimpleNamespace() for n in
                             (*kssd.SM90_ENTRIES, "ssd_sm90_bwd_scratch_floats",
                              "ssd_sm90_error_string")})
    kssd.sm90_interface(lib)
    assert getattr(lib, name).argtypes == kssd.SM90_ENTRIES[name]
    assert getattr(lib, name).restype is ctypes.c_int
    assert lib.ssd_sm90_bwd_scratch_floats.restype is ctypes.c_longlong


@pytest.mark.parametrize("b,l,h,chunk,seeded", [(32, 512, 6, 256, False), (128, 512, 6, 128, False),
                                                (1, 64, 1, 64, False), (2, 384, 2, 192, False),
                                                (32, 512, 6, 256, True), (1, 64, 1, 64, True)])
def test_sm90_backward_scratch(b, l, h, chunk, seeded):
    """The backward's scratch, section by section as the C side carves it:
    the head sum of dG, the dh carry (a slot more for dh_fin when seeded),
    h_in of chunks 1 .. nc - 1 in bf16 (half a float each), the row and
    column sums of dlogM, dT, dE over each half of d_state, the halves' sums
    of dh (.) h_in."""
    nc, t = l // chunk, chunk // 64
    state = h * 128 * 128
    sections = [b * nc * chunk * chunk, b * (nc - 1 + seeded) * state, b * (nc - 1) * state // 2,
                *[b * h * nc * (t * (t + 1) // 2) * 64] * 2, *[b * h * l] * 3, b * h * nc * 2]
    assert kssd.sm90_bwd_scratch_floats(b, l, h, chunk, seeded) == sum(sections)
    assert all(s % 4 == 0 for s in sections[:-1])  # every section starts 16-byte aligned


@pytest.mark.parametrize("offset,width,copied", [(0, 1024, False), (6, 1024, True),
                                                 (8, 1024, False), (0, 1022, True)])
def test_tma_rows_copies_only_rows_it_cannot_read(offset, width, copied):
    """``tma_rows`` hands a (b, l, w) tensor on when its start and its row and
    batch strides are 16-byte aligned (a contiguous tensor, or a view 8
    columns in) and copies it, equal, where they are not (6 columns in: 12
    bytes off; 1022 wide: rows 2044 bytes apart)."""
    base = torch.arange(2 * 64 * (width + 8), dtype=torch.float32).to(BF)
    t = base.reshape(2, 64, width + 8)[..., offset:offset + 256]
    got = kssd.tma_rows(t)
    aligned = t.data_ptr() % 16 == 0 and all(s * 2 % 16 == 0 for s in t.stride()[:2])
    assert copied == (not aligned)
    assert (got.data_ptr() != t.data_ptr()) == copied
    assert torch.equal(got, t) and got.is_contiguous() >= copied


class _Cuda:
    """What ``_launch_fwd`` / ``_launch_bwd`` ask of torch.cuda, for CPU
    tensors: a device context and a stream handle."""

    def __init__(self):
        self.stream = SimpleNamespace(cuda_stream=0)

    def device(self, _):
        import contextlib
        return contextlib.nullcontext()

    def current_stream(self, _=None):
        return self.stream


@pytest.fixture
def routed(monkeypatch):
    """_launch_fwd / _launch_bwd on CPU tensors with the C side replaced by
    recorders: which run function each call reached."""
    calls = []
    cuda = _Cuda()
    monkeypatch.setattr(kssd.torch.cuda, "device", cuda.device)
    monkeypatch.setattr(kssd.torch.cuda, "current_stream", cuda.current_stream)
    monkeypatch.setattr(kssd, "_check_inputs",
                        lambda xbc, dt, S, D, d, chunk, extra=None:
                        (xbc.shape[0], xbc.shape[1], dt.shape[1], (xbc.shape[-1] - d) // 2,
                         d // dt.shape[1]))
    for lib in ("_fwd_library", "_bwd_library", "_sm90_library"):
        monkeypatch.setattr(kssd, lib, lambda lib=lib: lib)

    def recorder(name):
        def run(lib, xbc, *a, **k):
            calls.append((name, lib))
            return (torch.zeros(1),) * 4
        return run

    for name in ("run_fwd", "run_bwd", "run_sm90_fwd", "run_sm90_bwd"):
        monkeypatch.setattr(kssd, name, recorder(name))
    return calls


def _counts():
    wrappers = {f.__name__: f.launches for f in kssd._WRAPPERS}
    return {**wrappers, **{k: v.launches for k, v in kssd.VARIANT_LAUNCHES.items()}}


def _moved(before):
    return {k: v - before[k] for k, v in _counts().items() if v != before[k]}


@pytest.mark.parametrize("dtype,chunk,states,hfin,run,count", [
    (BF, 256, False, False, "run_sm90_fwd", "ssd_xbc_fwd_sm90_bf16"),
    (BF, 128, True, False, "run_sm90_fwd", "ssd_xbc_fwd_states_sm90_bf16"),
    (BF, 64, True, False, "run_sm90_fwd", "ssd_xbc_fwd_states_sm90_bf16"),
    (BF, 256, False, True, "run_sm90_fwd", "ssd_xbc_fwd_hfin_sm90_bf16"),
    (BF, 128, True, True, "run_sm90_fwd", "ssd_xbc_fwd_states_hfin_sm90_bf16"),
    (F32, 256, False, True, "run_fwd", "ssd_xbc_fwd_hfin"),
    (BF, 32, False, False, "run_fwd", "ssd_xbc_fwd_strip_bf16"),
    (BF, 512, True, False, "run_fwd", "ssd_xbc_fwd_states_long_bf16"),
    (F32, 256, True, False, "run_fwd", "ssd_xbc_fwd_states"),
])
def test_forward_launches_the_body_that_owns_the_shape(routed, dtype, chunk, states, hfin, run,
                                                       count):
    """K8 at bf16 and a chunk the Hopper body serves launches it and counts
    on its '_sm90' count, with or without h_fin; at another chunk or at fp32
    the chunk-parallel body runs and counts as it did. Nothing else is
    called."""
    h, d = 6, 768
    xbc = torch.zeros(2, 512, d + 256, dtype=dtype)
    dt = torch.zeros(2, h, 512 // chunk, chunk)
    before = _counts()
    kssd._launch_fwd(xbc, dt, dt, torch.zeros(h), d, chunk, states, hfin=hfin)
    lib = "_sm90_library" if run == "run_sm90_fwd" else "_fwd_library"
    assert routed == [(run, lib)]
    assert _moved(before) == {count: 1}


@pytest.mark.parametrize("dtype,chunk,seeded,run,count", [
    (BF, 256, False, "run_sm90_bwd", "ssd_xbc_bwd_sm90_bf16"),
    (BF, 192, False, "run_sm90_bwd", "ssd_xbc_bwd_sm90_bf16"),
    (BF, 256, True, "run_sm90_bwd", "ssd_xbc_bwd_seeded_sm90_bf16"),
    (BF, 96, True, "run_bwd", "ssd_xbc_bwd_seeded_strip_bf16"),
    (BF, 96, False, "run_bwd", "ssd_xbc_bwd_strip_bf16"),
    (F32, 128, False, "run_bwd", "ssd_xbc_bwd"),
])
def test_backward_launches_the_body_that_owns_the_shape(routed, dtype, chunk, seeded, run,
                                                        count):
    """K9 likewise, seeded or not."""
    h, d, l = 6, 768, 384 if chunk == 192 else 512
    xbc = torch.zeros(2, l, d + 256, dtype=dtype)
    dt = torch.zeros(2, h, l // chunk, chunk)
    h_in = torch.zeros(2, l // chunk, h, 128, 128)
    dy = torch.zeros(2, l, d, dtype=dtype)
    before = _counts()
    kssd._launch_bwd(xbc, dt, dt, torch.zeros(h), h_in, dy, d, chunk,
                     dh_fin=torch.zeros(2, h, 128, 128) if seeded else None)
    lib = "_sm90_library" if run == "run_sm90_bwd" else "_bwd_library"
    assert routed == [(run, lib)]
    assert _moved(before) == {count: 1}


def test_split_core_keeps_its_body(routed, monkeypatch):
    """K6 and K7 at bf16 keep the chunk-parallel body and their own counts."""
    monkeypatch.setattr(kssd, "_check_split",
                        lambda x, dt, S, Bm, Cm, chunk, extra=None: (2, 512, 3, 128, 128))
    seen = []
    monkeypatch.setattr(kssd, "run_split_fwd", lambda lib, *a: seen.append(lib) or
                        (torch.zeros(1), None, None))
    before = _counts()
    x = torch.zeros(2, 512, 384, dtype=BF)
    kssd._launch_split_fwd(x, torch.zeros(2, 3, 2, 256), None, None, None, 256, True, False)
    assert seen == ["_fwd_library"] and routed == []
    assert _moved(before) == {"ssd_split_fwd_states_bf16": 1}
