"""The port's CUDA kernels against their plain PyTorch versions, on the card.

The tests marked ``cuda`` need a CUDA device and the CUDA toolkit (the
kernels have no CPU mode) and skip without one; the gradient checks of the
autograd Functions run their plain path in float64 on any host. The file
imports only the port, so on a machine with a GPU and no JAX it runs with
the suite's conftest left out:

    python -m pytest --noconftest -q tests/test_torch_port_cuda.py
"""

import itertools
import json

import numpy as np
import pytest
import torch

from si_mamba_tpu_torch.models import PointMamba, PointMambaConfig
from si_mamba_tpu_torch.ops import selective_scan as tss
from si_mamba_tpu_torch.ops.kernels import causal_conv as kconv
from si_mamba_tpu_torch.ops.kernels import selective_scan as kscan


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _randn(rng, *shape, scale=1.0, device="cpu"):
    return torch.tensor(rng.standard_normal(shape).astype(np.float32) * scale, device=device)


def _close_to_max(got, want, tol):
    """max |got - want| within tol * max |want| (sums taken in other orders)."""
    err = (got - want).abs().max().item()
    assert err <= tol * want.abs().max().item(), (err, want.abs().max().item())


@pytest.mark.cuda
@pytest.mark.parametrize("b,l,d,row,off", [
    (2, 37, 24, 48, 0), (2, 512, 200, 400, 0), (2, 64, 130, 260, 0), (2, 65, 768, 1536, 0),
    (32, 512, 1024, 1798, 768),  # the SSD view: 8-byte accesses
    (32, 512, 384, 384, 0),      # the tensor-parallel SSD x shard
    (32, 512, 256, 256, 0),      # the tensor-parallel SSD B|C
    (32, 512, 384, 768, 0),      # the tensor-parallel Mamba-1 xi
    (1, 512, 768, 1536, 0),      # one cloud
    (3, 100, 1024, 1798, 768),   # L not a multiple of any tile
])
def test_conv_kernel_matches_plain(cuda, b, l, d, row, off):
    rng = np.random.default_rng(0)
    xz = _randn(rng, b, l, row, device=cuda)
    weight, bias = _randn(rng, d, 4, scale=0.5, device=cuda), _randn(rng, d, scale=0.1, device=cuda)
    x = xz[..., off:off + d]  # a column slice, as in the mixer
    before = kconv.causal_conv1d_silu.launches
    got = kconv.causal_conv1d_silu(x, weight, bias)
    torch.cuda.synchronize()
    assert kconv.causal_conv1d_silu.launches == before + 1
    torch.testing.assert_close(got, kconv.causal_conv1d_ref(x, weight, bias),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_conv_kernel_matches_plain_at_every_built_plan(cuda, dtype):
    """K1 at every vector width, time tile and block the source builds, on
    views whose alignment allows each width, at a ragged L: fp32 within
    rtol 1e-5 / atol 1e-6, bf16 within one ulp, one launch each."""
    rng = np.random.default_rng(9)
    counter = kconv.causal_conv1d_silu_bf16 if dtype == torch.bfloat16 else kconv.causal_conv1d_silu
    buf = _randn(rng, 3, 45, 400, device=cuda).to(dtype)
    d = 128
    weight, bias = _randn(rng, d, 4, scale=0.5, device=cuda), _randn(rng, d, scale=0.1, device=cuda)
    for vec in kconv.fwd_vectors(buf.element_size()):
        x = buf[..., vec:vec + d]  # vec elements in: aligned to vec, not to 2 vec
        want = kconv.causal_conv1d_ref(x, weight, bias)
        for tile, warps in itertools.product(kconv.FWD_TILES, kconv.FWD_WARPS):
            before = counter.launches
            y = kconv._run_fwd(x, weight, bias, kconv.FwdPlan(vec, tile, warps, (0, 0)))
            torch.cuda.synchronize()
            assert counter.launches == before + 1
            if dtype == torch.bfloat16:
                assert _bf16_ulps(y, want) <= 1, (vec, tile, warps)
            else:
                torch.testing.assert_close(y, want, rtol=1e-5, atol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_conv_forward_entry_points_refuse_plans_the_operands_do_not_allow(cuda, dtype):
    """A vector width that x's address, its row stride or D does not allow,
    one wider than built, a time tile or a block that is not built: the C
    entry point refuses it (cudaErrorInvalidValue) and nothing launches."""
    rng = np.random.default_rng(10)
    widest = kconv.fwd_vectors(torch.empty((), dtype=dtype).element_size())[0]
    buf = _randn(rng, 2, 20, 3 * widest + 64, device=cuda).to(dtype)
    weight, bias = _randn(rng, 64, 4, device=cuda), _randn(rng, 64, device=cuda)
    counter = kconv.causal_conv1d_silu_bf16 if dtype == torch.bfloat16 else kconv.causal_conv1d_silu
    plans = [(buf[..., 1:65], kconv.FwdPlan(2, 8, 4, (0, 0))),            # odd address
             (buf[..., :64], kconv.FwdPlan(2 * widest, 8, 4, (0, 0))),    # wider than built
             (buf[..., 1:63], kconv.FwdPlan(1, 16, 4, (0, 0))),           # a tile not built
             (buf[..., :64], kconv.FwdPlan(widest, 8, 3, (0, 0))),        # a block not built
             (buf[..., :63], kconv.FwdPlan(widest, 8, 4, (0, 0)))]        # D % vec != 0
    rows = buf.as_strided((2, 20, 64), (buf.stride(0), widest + 1, 1))  # row stride not a multiple
    plans.append((rows, kconv.FwdPlan(widest, 8, 4, (0, 0))))
    for x, plan in plans:
        before = counter.launches
        with pytest.raises(RuntimeError, match="invalid argument"):
            kconv._run_fwd(x, weight[:x.shape[2]].contiguous(), bias[:x.shape[2]].contiguous(),
                           plan)
        assert counter.launches == before
    # a weight 4 bytes past a 16-byte boundary: the entry point refuses it, the
    # wrapper hands the kernel an aligned copy
    x, shifted = buf[..., :64], torch.cat([weight.new_zeros(1), weight.flatten()])[1:].view(64, 4)
    assert shifted.data_ptr() % 16 != 0
    with pytest.raises(RuntimeError, match="invalid argument"):
        kconv._run_fwd(x, shifted, bias, kconv.fwd_plan(x))
    y, want = kconv.causal_conv1d_silu_fwd(x, shifted, bias), kconv.causal_conv1d_ref(x, weight, bias)
    torch.cuda.synchronize()
    if dtype == torch.bfloat16:
        assert _bf16_ulps(y, want) <= 1
    else:
        torch.testing.assert_close(y, want, rtol=1e-5, atol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("l,d", [(64, 32), (50, 200), (33, 96), (512, 768)])
def test_scan_kernel_matches_plain(cuda, l, d):
    rng = np.random.default_rng(1)
    b, n = 2, 16
    x_dbl = _randn(rng, b, l, 3 + 2 * n, device=cuda)  # B and C are column slices
    u, delta, z = (_randn(rng, b, l, d, device=cuda) for _ in range(3))
    A = -torch.exp(_randn(rng, d, n, device=cuda))
    D, dt_bias = _randn(rng, d, device=cuda), _randn(rng, d, scale=0.1, device=cuda)
    Bm, Cm = x_dbl[..., 3:3 + n], x_dbl[..., 3 + n:]
    before = kscan.selective_scan_fwd.launches
    got = kscan.selective_scan_fwd(u, delta, A, Bm, Cm, D, z, dt_bias)
    torch.cuda.synchronize()
    assert kscan.selective_scan_fwd.launches == before + 1
    want = kscan.selective_scan_ref(u, delta, A, Bm, Cm, D=D, z=z, delta_bias=dt_bias)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5 * want.abs().max().item())


@pytest.mark.cuda
def test_kernels_reject_what_they_do_not_take(cuda):
    rng = np.random.default_rng(2)
    x = _randn(rng, 1, 8, 16, device=cuda)
    with pytest.raises(TypeError):
        kconv.causal_conv1d_silu(x.double(), _randn(rng, 16, 4, device=cuda),
                                 _randn(rng, 16, device=cuda))
    # widths 3 and 5 run the any-width K1 (not the plain conv), as JAX's
    # Pallas conv takes any width; a width of 0 raises
    for w in (3, 5):
        wt, bias = _randn(rng, 16, w, device=cuda), _randn(rng, 16, device=cuda)
        before = kconv.ANY_LAUNCHES["causal_conv1d_silu_any"].launches
        got = kconv.causal_conv1d_silu(x, wt, bias)
        assert kconv.ANY_LAUNCHES["causal_conv1d_silu_any"].launches == before + 1
        _close_to_max(got, kconv.causal_conv1d_ref(x, wt, bias), 1e-5)
    with pytest.raises(ValueError, match="width of at least 1"):
        kconv.causal_conv1d_silu(x, _randn(rng, 16, 0, device=cuda), _randn(rng, 16, device=cuda))
    with pytest.raises(ValueError, match="one CUDA device"):
        kconv.causal_conv1d_silu(x, _randn(rng, 16, 4), _randn(rng, 16))
    # d_state 5 and 300 (its arrays in the global workspace) run the
    # any-state K2, as JAX's Pallas scan takes any d_state; d_state 0 raises
    u = _randn(rng, 1, 8, 16, device=cuda)
    D, db = _randn(rng, 16, device=cuda), _randn(rng, 16, device=cuda)
    for n in (5, 300):
        BC = _randn(rng, 1, 8, n, device=cuda)
        A = -_randn(rng, 16, n, device=cuda).abs()
        before = kscan.ANY_LAUNCHES["selective_scan_fwd_any"].launches
        got = kscan.selective_scan_fwd(u, u, A, BC, BC, D, u, db)
        assert kscan.ANY_LAUNCHES["selective_scan_fwd_any"].launches == before + 1
        _close_to_max(got, kscan.selective_scan_ref(u, u, A, BC, BC, D=D, z=u, delta_bias=db),
                      1e-5)
    empty = _randn(rng, 1, 8, 0, device=cuda)
    with pytest.raises(ValueError, match="d_state 1 or more"):
        kscan.selective_scan_fwd(u, u, _randn(rng, 16, 0, device=cuda), empty, empty, D, u, db)


@pytest.mark.cuda
@pytest.mark.parametrize("drop", ["D", "z", "delta_bias", "delta_softplus"])
def test_auto_scan_on_cuda_raises_without_the_full_signature(cuda, drop):
    """'auto' on a CUDA tensor is the kernel or an error, never the plain scan."""
    rng = np.random.default_rng(6)
    u = _randn(rng, 1, 8, 32, device=cuda)
    BC = _randn(rng, 1, 8, 16, device=cuda)
    kw = dict(D=_randn(rng, 32, device=cuda), z=u, delta_bias=_randn(rng, 32, device=cuda),
              delta_softplus=True)
    kw[drop] = False if drop == "delta_softplus" else None
    before = kscan.selective_scan_fwd.launches
    with pytest.raises(NotImplementedError, match=drop):
        tss.selective_scan(u, u, -torch.exp(_randn(rng, 32, 16, device=cuda)), BC, BC, **kw,
                           impl="auto")
    assert kscan.selective_scan_fwd.launches == before


@pytest.mark.cuda
def test_mixer_kernel_path_matches_plain(cuda):
    from si_mamba_tpu_torch.models.layers import MambaMixer

    mixer = MambaMixer(64, out_proj_div=2.0)
    mixer.reset_parameters(torch.Generator().manual_seed(3))
    p = {k: v.detach().to(cuda) for k, v in mixer.params().items()}
    x = _randn(np.random.default_rng(4), 3, 96, 64, device=cuda)
    conv0, scan0 = kconv.causal_conv1d_silu.launches, kscan.selective_scan_fwd.launches
    got = tss.mamba_mixer_apply(p, x, d_state=16, dt_rank=mixer.dt_rank, impl="auto")
    assert kconv.causal_conv1d_silu.launches == conv0 + 1
    assert kscan.selective_scan_fwd.launches == scan0 + 1
    want = tss.mamba_mixer_apply(p, x, d_state=16, dt_rank=mixer.dt_rank, impl="seq")
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5 * want.abs().max().item())


@pytest.mark.cuda
def test_small_model_kernel_path_matches_plain(cuda):
    cfg = dict(trans_dim=64, encoder_dims=64, depth=2, cls_dim=5, num_group=32,
               group_size=16, drop_path=0.0)
    model = PointMamba(PointMambaConfig(**cfg)).to(cuda).eval()
    plain = PointMamba(PointMambaConfig(**cfg, scan_impl="seq")).to(cuda).eval()
    plain.load_state_dict(model.state_dict(), strict=True)
    pts = _randn(np.random.default_rng(5), 3, 256, 3, device=cuda)
    with torch.inference_mode():
        got, feat = model(pts, return_features=True)
        want, feat_ref = plain(pts, return_features=True)
    torch.testing.assert_close(got, want, rtol=2e-3, atol=1e-3 * want.abs().max().item())
    torch.testing.assert_close(feat, feat_ref, rtol=2e-3,
                               atol=1e-3 * feat_ref.abs().max().item())


# ---------------------------------------------------------------------------
# the training kernels (K3, K4, K5) and the autograd Functions
# ---------------------------------------------------------------------------

def _scan_case(rng, b, l, d, device, n=16):
    """The scan's inputs as the mixer makes them: u and z column halves of
    one (b, l, 2d) buffer, B and C column slices of x_dbl, g a column view."""
    xz = _randn(rng, b, l, 2 * d, device=device)
    x_dbl = _randn(rng, b, l, 3 + 2 * n, device=device)
    gbuf = _randn(rng, b, l, d + 5, device=device)
    return dict(u=xz[..., :d], delta=_randn(rng, b, l, d, scale=0.5, device=device),
                A=-torch.exp(_randn(rng, d, n, device=device)),
                B=x_dbl[..., 3:3 + n], C=x_dbl[..., 3 + n:],
                D=_randn(rng, d, device=device), z=xz[..., d:],
                delta_bias=_randn(rng, d, scale=0.1, device=device), g=gbuf[..., 5:])


def _conv_bwd_case(rng, b, l, d, row, off, g_off, device):
    """x: columns off:off+d of a (b, l, row) buffer, as the mixers slice it;
    g: columns g_off: of a (b, l, d + g_off) buffer."""
    x = _randn(rng, b, l, row, device=device)[..., off:off + d]
    g = _randn(rng, b, l, d + g_off, device=device)[..., g_off:]
    weight, bias = _randn(rng, d, 4, scale=0.5, device=device), _randn(rng, d, scale=0.1,
                                                                        device=device)
    return x, weight, bias, g


@pytest.mark.cuda
@pytest.mark.parametrize("b,l,d,row,off,g_off", [
    pytest.param(3, 50, 96, 192, 96, 3, id="50-96"),
    pytest.param(3, 512, 768, 1536, 768, 3, id="512-768"),
    pytest.param(2, 512, 1024, 1798, 768, 0, id="ssd-view-1024-row1798"),
    pytest.param(3, 512, 200, 400, 200, 0, id="ragged-width-200"),
    pytest.param(3, 50, 768, 1536, 0, 0, id="length-50"),
    pytest.param(3, 130, 768, 1536, 0, 0, id="length-130"),
    pytest.param(1, 512, 768, 1536, 0, 0, id="batch-1"),
    pytest.param(2, 512, 256, 256, 0, 0, id="width-256"),
    pytest.param(2, 512, 384, 384, 0, 0, id="width-384"),
    pytest.param(2, 130, 130, 261, 1, 1, id="odd-stride-width-130"),
])
def test_conv_bwd_kernel_matches_plain(cuda, b, l, d, row, off, g_off):
    rng = np.random.default_rng(7)
    x, weight, bias, g = _conv_bwd_case(rng, b, l, d, row, off, g_off, cuda)
    before = kconv.causal_conv1d_silu_bwd.launches
    got = kconv.causal_conv1d_silu_bwd(x, weight, bias, g)
    torch.cuda.synchronize()
    assert kconv.causal_conv1d_silu_bwd.launches == before + 1
    for a, want in zip(got, kconv.causal_conv1d_silu_bwd_ref(x, weight, bias, g)):
        assert a.shape == want.shape
        _close_to_max(a, want, 1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("b,tile", [(32, 64), (16, 32), (2, 16)])
def test_conv_bwd_kernel_with_each_time_tile(cuda, b, tile):
    """Each tile the plan picks, through the batch that makes it pick it, at
    a length that is a multiple of none of them (the last tile ragged) and at
    the SSD view's 8-byte rows."""
    rng = np.random.default_rng(8)
    x, weight, bias, g = _conv_bwd_case(rng, b, 300, 1024, 1798, 768, 0, cuda)
    assert kconv.bwd_plan(x, g, 4, torch.cuda.get_device_properties(cuda)
                          .multi_processor_count).tile == tile
    got = kconv.causal_conv1d_silu_bwd(x, weight, bias, g)
    for a, want in zip(got, kconv.causal_conv1d_silu_bwd_ref(x, weight, bias, g)):
        _close_to_max(a, want, 1e-5)


@pytest.mark.cuda
def test_conv_bwd_kernel_runs_are_bitwise_equal(cuda):
    """dw and db are summed in a fixed order (no atomics): two runs on the
    same inputs give the same bits."""
    rng = np.random.default_rng(9)
    args = _conv_bwd_case(rng, 32, 512, 768, 1536, 0, 0, cuda)
    first, again = kconv.causal_conv1d_silu_bwd(*args), kconv.causal_conv1d_silu_bwd(*args)
    torch.cuda.synchronize()
    for a, b in zip(first, again):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_conv_bwd_entry_point_refuses_what_the_alignment_does_not_allow(cuda):
    """The C entry point checks each vector width against the operand's
    address and strides, that the pair of widths is a built variant, the
    tile and the partials' size."""
    rng = np.random.default_rng(10)
    x, weight, bias, g = _conv_bwd_case(rng, 2, 64, 1024, 1798, 768, 0, cuda)
    B, L, D = x.shape
    plan = kconv.bwd_plan(x, g)
    assert (plan.vx, plan.vg) == (2, 4)
    f32 = dict(dtype=torch.float32, device=cuda)
    dx, dw, db = torch.empty((B, L, D), **f32), torch.empty((D, 4), **f32), torch.empty(D, **f32)
    part = torch.empty(plan.partial_shape, **f32)
    lib = kconv._library()
    stream = torch.cuda.current_stream().cuda_stream

    def call(vx=plan.vx, vg=plan.vg, tile=plan.tile, numel=part.numel(), xv=x):
        return lib.causal_conv1d_silu_bwd(
            xv.data_ptr(), weight.data_ptr(), bias.data_ptr(), g.data_ptr(), dx.data_ptr(),
            dw.data_ptr(), db.data_ptr(), part.data_ptr(), numel, B, L, D, 4, xv.stride(0),
            xv.stride(1), g.stride(0), g.stride(1), vx, vg, tile, stream)

    assert call() == 0
    assert call(vx=4) != 0  # rows 7192 bytes apart: 8-byte aligned only
    assert call(vx=3) != 0
    assert call(vx=2, xv=x[..., 1:]) != 0  # a base 4 bytes past an aligned one
    assert call(vx=1, vg=1) == 0  # narrower than allowed is allowed
    assert call(vx=1, vg=4) != 0  # a pair that is not built
    assert call(tile=14) != 0 and call(tile=4) != 0
    assert call(numel=part.numel() - 1) != 0
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("l,d", [(50, 96), (130, 200)])
def test_scan_residual_fwd_kernel_matches_plain(cuda, l, d):
    rng = np.random.default_rng(8)
    case = _scan_case(rng, 2, l, d, cuda)
    args = [case[k] for k in kscan._NAMES]
    k2, k3 = kscan.selective_scan_fwd.launches, kscan.selective_scan_fwd_residuals.launches
    y, h_entries = kscan.selective_scan_fwd_residuals(*args)
    y_lean = kscan.selective_scan_fwd(*args)
    torch.cuda.synchronize()
    assert kscan.selective_scan_fwd_residuals.launches == k3 + 1
    assert kscan.selective_scan_fwd.launches == k2 + 1
    torch.testing.assert_close(y, y_lean, rtol=0, atol=0)  # the same arithmetic
    y_ref, h_ref = kscan.selective_scan_fwd_residuals_ref(*args)
    assert h_entries.shape == h_ref.shape == (2, -(-l // kscan.CHUNK), 16, d)
    _close_to_max(y, y_ref, 1e-5)
    _close_to_max(h_entries, h_ref, 1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("l,d", [(50, 96), (512, 200)])
def test_scan_bwd_kernel_matches_plain(cuda, l, d):
    rng = np.random.default_rng(9)
    case = _scan_case(rng, 2, l, d, cuda)
    args = [case[k] for k in kscan._NAMES]
    _, h_entries = kscan.selective_scan_fwd_residuals_ref(*args)
    before = kscan.selective_scan_bwd.launches
    got = kscan.selective_scan_bwd(*args, case["g"], h_entries)
    torch.cuda.synchronize()
    assert kscan.selective_scan_bwd.launches == before + 1
    want = kscan.selective_scan_bwd_ref(*args, case["g"], h_entries)
    for name, a, b in zip(("du", "ddelta", "dA", "dB", "dC", "dD", "dz", "ddelta_bias"),
                          got, want):
        assert a.shape == b.shape, name
        _close_to_max(a, b, 1e-4)


@pytest.mark.cuda
def test_fused_scan_takes_the_lean_kernel_without_a_gradient(cuda):
    rng = np.random.default_rng(10)
    case = _scan_case(rng, 2, 40, 64, cuda)
    args = [case[k] for k in kscan._NAMES]
    counts = lambda: (kscan.selective_scan_fwd.launches,  # noqa: E731
                      kscan.selective_scan_fwd_residuals.launches,
                      kscan.selective_scan_bwd.launches)
    k2, k3, k4 = counts()
    kscan.selective_scan_fused(*args)
    assert counts() == (k2 + 1, k3, k4)
    u = args[0].detach().clone().requires_grad_()
    with torch.no_grad():
        kscan.selective_scan_fused(u, *args[1:])
    assert counts() == (k2 + 2, k3, k4)
    y = kscan.selective_scan_fused(u, *args[1:])
    assert isinstance(y.grad_fn, kscan.SelectiveScanFn._backward_cls)
    y.backward(case["g"])
    assert counts() == (k2 + 2, k3 + 1, k4 + 1)
    assert u.grad is not None and torch.isfinite(u.grad).all()


def _scan_kernels_against_plain(case, segments=None):
    """K2, K3 and K4 on one case against their plain versions at the
    tolerances of chip_smoke.py: K2 rtol 1e-4, atol 1e-5 max|y|; K3 1e-4 of
    each output's max, its y equal to K2's bit for bit; K4 1e-3 of each
    gradient's max (sums over channels and steps in another order), two runs
    bitwise equal."""
    args = [case[k] for k in kscan._NAMES]
    y2 = kscan._launch_fwd(*args, residuals=False, segments=segments)[0]
    y3, h3 = kscan._launch_fwd(*args, residuals=True, segments=segments)
    got = kscan.selective_scan_bwd(*args, case["g"], h3)
    again = kscan.selective_scan_bwd(*args, case["g"], h3)
    torch.cuda.synchronize()
    y_ref, h_ref = kscan.selective_scan_fwd_residuals_ref(*args)
    torch.testing.assert_close(y2, y_ref, rtol=1e-4, atol=1e-5 * y_ref.abs().max().item())
    assert torch.equal(y3, y2)
    _close_to_max(h3, h_ref, 1e-4)
    want = kscan.selective_scan_bwd_ref(*args, case["g"], h3)
    for name, a, a2, b in zip(("du", "ddelta", "dA", "dB", "dC", "dD", "dz", "ddelta_bias"),
                              got, again, want):
        assert a.shape == b.shape, name
        assert torch.equal(a, a2), name
        _close_to_max(a, b, 1e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("b,l,d", [(2, 37, 24), (3, 100, 200), (1, 65, 130), (1, 512, 768),
                                   (32, 512, 768)])
def test_scan_kernels_at_ragged_and_path_shapes(cuda, b, l, d):
    """L not a multiple of the 16-step tile, d not a multiple of the blocks'
    channels (32 forward, 64 backward) nor of a warp's 8, and the path's
    width at one cloud and at the train batch."""
    _scan_kernels_against_plain(_scan_case(np.random.default_rng(40), b, l, d, cuda))


@pytest.mark.cuda
@pytest.mark.parametrize("segments", [1, 2, 3, 16])
def test_scan_fwd_kernels_with_each_segment_count(cuda, segments):
    """The segmented forward (end states from zero, then the rescan from the
    composed entry states) at a forced segment count, 1 being the one-pass
    scan; 16 at L=200 leaves 13 one-tile segments."""
    case = _scan_case(np.random.default_rng(41), 2, 200, 96, cuda)
    _scan_kernels_against_plain(case, segments=segments)


@pytest.mark.cuda
def test_scan_kernels_under_strong_decay(cuda):
    """delta |A| of 10 to 100: a state forgets within a step or two, and
    exp(A * sum delta) of a segment underflows to 0."""
    rng = np.random.default_rng(42)
    case = _scan_case(rng, 2, 130, 72, cuda)
    case["delta"] = _randn(rng, 2, 130, 72, scale=2.0, device=cuda) + 3.0
    case["A"] = -torch.exp(_randn(rng, 72, 16, scale=0.5, device=cuda) + 2.5)
    for segments in (None, 1, 4):
        _scan_kernels_against_plain(case, segments=segments)


@pytest.mark.cuda
def test_scan_fwd_segment_choice_follows_the_batch(cuda):
    """The kernel cuts L into segments only while the one-pass grid leaves
    the card idle: at one cloud, not at the train batch."""
    lib = kscan._fwd_library()
    assert lib.selective_scan_fwd_segments(1, 512, 768) > 1
    assert lib.selective_scan_fwd_segments(32, 512, 768) == 1


def test_functions_gradcheck_in_float64_through_the_plain_path():
    """The plain forward/backward pairs of both Functions, in float64 on the
    CPU (the kernels take float32 and are held against these instead)."""
    rng = np.random.default_rng(11)
    case = _scan_case(rng, 2, 21, 6, "cpu", n=3)
    args = [case[k].double().requires_grad_() for k in kscan._NAMES]
    assert torch.autograd.gradcheck(kscan.SelectiveScanFn.apply, args)
    x = _randn(rng, 2, 13, 10)[..., 2:].double().requires_grad_()
    w = (_randn(rng, 8, 4) * 0.5).double().requires_grad_()
    b = _randn(rng, 8).double().requires_grad_()
    assert torch.autograd.gradcheck(kconv.CausalConv1dSiluFn.apply, (x, w, b))


@pytest.mark.cuda
def test_mixer_grads_on_the_kernel_path_match_seq(cuda):
    from si_mamba_tpu_torch.models.layers import MambaMixer

    mixer = MambaMixer(64, out_proj_div=2.0)
    mixer.reset_parameters(torch.Generator().manual_seed(12))
    plain = MambaMixer(64, out_proj_div=2.0, scan_impl="seq")
    plain.load_state_dict(mixer.state_dict())
    mixer, plain = mixer.to(cuda), plain.to(cuda)
    rng = np.random.default_rng(13)
    x = _randn(rng, 3, 80, 64, device=cuda)
    g = _randn(rng, 3, 80, 64, device=cuda)
    before = (kconv.causal_conv1d_silu_bwd.launches, kscan.selective_scan_bwd.launches)
    mixer(x).backward(g)
    assert (kconv.causal_conv1d_silu_bwd.launches, kscan.selective_scan_bwd.launches) == (
        before[0] + 1, before[1] + 1)
    plain(x).backward(g)
    for (name, p), q in zip(mixer.named_parameters(), plain.parameters()):
        assert p.grad is not None, name
        _close_to_max(p.grad, q.grad, 1e-4)


# ---------------------------------------------------------------------------
# the SSD kernels (K8, K9) and their autograd Function
# ---------------------------------------------------------------------------

def _ssd_case(rng, b, l, h, chunk, device, n=128, p=128):
    """xbc as a column slice of a wider buffer (unit stride along channels
    only), dt and S in the kernels' (b, h, nc, q) layout, D (h,)."""
    d = h * p
    xbc = _randn(rng, b, l, d + 2 * n + 6, scale=0.5, device=device)[..., 6:]
    dt = torch.nn.functional.softplus(_randn(rng, b, l, h, device=device) - 1.0)
    A = -torch.exp(_randn(rng, h, device=device))
    dth = dt.transpose(1, 2).reshape(b, h, l // chunk, chunk).contiguous()
    S = torch.cumsum(dth * A[None, :, None, None], dim=-1)
    return xbc, dth, S, _randn(rng, h, device=device), d


@pytest.mark.cuda
@pytest.mark.parametrize("b,l,h,chunk", [(2, 512, 2, 256), (1, 192, 1, 64), (2, 384, 3, 128)])
def test_ssd_fwd_kernels_match_plain(cuda, b, l, h, chunk):
    from si_mamba_tpu_torch.ops.kernels import ssd as kssd

    xbc, dth, S, D, d = _ssd_case(np.random.default_rng(20), b, l, h, chunk, cuda)
    k_lean, k_states = kssd.ssd_xbc_fwd.launches, kssd.ssd_xbc_fwd_states.launches
    y_lean = kssd.ssd_xbc_fwd(xbc, dth, S, D, d, chunk)
    y, h_in = kssd.ssd_xbc_fwd_states(xbc, dth, S, D, d, chunk)
    torch.cuda.synchronize()
    assert (kssd.ssd_xbc_fwd.launches, kssd.ssd_xbc_fwd_states.launches) == (k_lean + 1,
                                                                             k_states + 1)
    torch.testing.assert_close(y, y_lean, rtol=0, atol=0)  # the same arithmetic
    y_ref, h_ref = kssd.ssd_xbc_fwd_ref(xbc, dth, S, D, d, chunk, emit_states=True)
    assert h_in.shape == h_ref.shape == (b, l // chunk, h, 128, 128)
    _close_to_max(y, y_ref, 1e-5)
    _close_to_max(h_in, h_ref, 1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("b,l,h,chunk", [(2, 512, 2, 256), (1, 192, 3, 64)])
def test_ssd_bwd_kernel_matches_plain(cuda, b, l, h, chunk):
    from si_mamba_tpu_torch.ops.kernels import ssd as kssd

    rng = np.random.default_rng(21)
    xbc, dth, S, D, d = _ssd_case(rng, b, l, h, chunk, cuda)
    dy = _randn(rng, b, l, d + 3, device=cuda)[..., 3:]
    _, h_in = kssd.ssd_xbc_fwd_ref(xbc, dth, S, D, d, chunk, emit_states=True)
    before = kssd.ssd_xbc_bwd.launches
    got = kssd.ssd_xbc_bwd(xbc, dth, S, D, h_in, dy, d, chunk)
    torch.cuda.synchronize()
    assert kssd.ssd_xbc_bwd.launches == before + 1
    want = kssd.ssd_xbc_bwd_ref(xbc, dth, S, D, h_in, dy, d, chunk)
    for name, a, w in zip(("dxbc", "ddt", "dS", "dD"), got, want):
        assert a.shape == w.shape, name
        _close_to_max(a, w, 1e-4)


@pytest.mark.cuda
def test_ssd_kernels_reject_what_they_do_not_take(cuda):
    from si_mamba_tpu_torch.ops.kernels import ssd as kssd

    rng = np.random.default_rng(22)
    xbc, dth, S, D, d = _ssd_case(rng, 1, 128, 1, 64, cuda)
    # chunk 32 runs laid out in strips, as JAX's kernel takes any multiple of 8;
    # chunk 12 (no multiple of 8, refused by JAX too) raises
    dt32, S32 = dth.reshape(1, 1, 4, 32).contiguous(), S.reshape(1, 1, 4, 32).contiguous()
    _close_to_max(kssd.ssd_xbc_fwd(xbc, dt32, S32, D, d, 32),
                  kssd.ssd_xbc_fwd_ref(xbc, dt32, S32, D, d, 32)[0], 1e-5)
    dt12, S12 = (t.reshape(1, 1, 128)[..., :120].reshape(1, 1, 10, 12).contiguous()
                 for t in (dth, S))
    with pytest.raises(ValueError, match="multiple of 8"):
        kssd.ssd_xbc_fwd(xbc[:, :120], dt12, S12, D, d, 12)
    for n in (64, 192):  # d_state no multiple of 128, which JAX refuses too
        small, dth2, S2, D2, d2 = _ssd_case(rng, 1, 128, 1, 64, cuda, n=n)
        with pytest.raises(ValueError, match=f"multiples of 128.*d_state {n} "):
            kssd.ssd_xbc_fwd(small, dth2, S2, D2, d2, 64)
    with pytest.raises(TypeError):
        kssd.ssd_xbc_fwd(xbc.double(), dth, S, D, d, 64)
    with pytest.raises(ValueError, match="CUDA device"):
        kssd.ssd_xbc_fwd(xbc, dth, S, D.cpu(), d, 64)
    with pytest.raises(ValueError, match="multiple of chunk"):
        kssd.ssd_chunked_xbc(xbc[:, :100], torch.ones(1, 100, 1, device=cuda),
                             -torch.ones(1, device=cuda), D, d_inner=d, chunk=64)


def _ssd_mixer_xbc(rng, b, l, h, layout, device, n=128, p=128):
    """xbc (b, l, h p + 2n) as the SSD mixer makes it ("conv": K1's output
    on the column view of a wider in_proj buffer, contiguous), or a column
    view of a wider buffer whose rows are not 16-byte aligned ("view")."""
    width = h * p + 2 * n
    if layout == "view":
        return _randn(rng, b, l, width + 6, scale=0.5, device=device)[..., 6:]
    zxbcdt = _randn(rng, b, l, 2 * width + h, scale=0.5, device=device)
    w, bias = _randn(rng, width, 4, scale=0.5, device=device), _randn(rng, width, device=device)
    return kconv.causal_conv1d_silu_fwd(zxbcdt[..., h * p:h * p + width], w, bias)


@pytest.mark.cuda
@pytest.mark.parametrize("b,l,h,chunk,layout,decay", [
    (1, 64, 1, 64, "conv", 1.0),      # nc 1
    (3, 256, 3, 128, "view", 1.0),    # nc 2
    (3, 512, 6, 256, "conv", 1.0),    # nc 2, the classifier's chunk and heads
    (1, 1024, 6, 256, "conv", 1.0),   # nc 4, the hardest geometry's L
    (1, 256, 6, 64, "view", 30.0),    # nc 4, strong decay
    (3, 1024, 1, 64, "view", 1.0),    # nc 16
    (1, 2048, 3, 128, "conv", 1.0),   # nc 16
])
def test_ssd_kernels_match_plain_across_geometries(cuda, b, l, h, chunk, layout, decay):
    """K8 (lean and with states) and K9 against their plain versions over
    chunk counts 1 to 16, chunks 64 to 256, 1 to 6 heads and both layouts of
    xbc: the lean y bitwise equal to the states variant's, two K9 runs
    bitwise equal."""
    from si_mamba_tpu_torch.ops.kernels import ssd as kssd

    rng = np.random.default_rng(27)
    xbc = _ssd_mixer_xbc(rng, b, l, h, layout, cuda)
    d = h * 128
    dt = torch.nn.functional.softplus(_randn(rng, b, l, h, device=cuda) - 1.0)
    A = -decay * torch.exp(_randn(rng, h, device=cuda))
    dth = dt.transpose(1, 2).reshape(b, h, l // chunk, chunk).contiguous()
    S = torch.cumsum(dth * A[None, :, None, None], dim=-1)
    D = _randn(rng, h, device=cuda)
    counts = lambda: (kssd.ssd_xbc_fwd.launches, kssd.ssd_xbc_fwd_states.launches,  # noqa: E731
                      kssd.ssd_xbc_bwd.launches)
    before = counts()
    y_lean = kssd.ssd_xbc_fwd(xbc, dth, S, D, d, chunk)
    y, h_in = kssd.ssd_xbc_fwd_states(xbc, dth, S, D, d, chunk)
    dy = _randn(rng, b, l, d + 3, device=cuda)[..., 3:]
    got = kssd.ssd_xbc_bwd(xbc, dth, S, D, h_in, dy, d, chunk)
    again = kssd.ssd_xbc_bwd(xbc, dth, S, D, h_in, dy, d, chunk)
    torch.cuda.synchronize()
    assert counts() == (before[0] + 1, before[1] + 1, before[2] + 2)
    torch.testing.assert_close(y, y_lean, rtol=0, atol=0)
    for a, w in zip(got, again):
        torch.testing.assert_close(a, w, rtol=0, atol=0)
    y_ref, h_ref = kssd.ssd_xbc_fwd_ref(xbc, dth, S, D, d, chunk, emit_states=True)
    _close_to_max(y, y_ref, 1e-5)
    _close_to_max(h_in, h_ref, 1e-5)
    want = kssd.ssd_xbc_bwd_ref(xbc, dth, S, D, h_in, dy, d, chunk)
    for name, a, w in zip(("dxbc", "ddt", "dS", "dD"), got, want):
        assert a.shape == w.shape, name
        assert torch.isfinite(a).all(), name
        _close_to_max(a, w, 1e-4)


@pytest.mark.cuda
def test_ssd_kernels_refuse_scratch_of_another_size(cuda):
    """The C entry points check the scratch sizes the wrapper hands them."""
    from si_mamba_tpu_torch.ops.kernels import ssd as kssd

    rng = np.random.default_rng(28)
    xbc, dth, S, D, d = _ssd_case(rng, 1, 128, 1, 64, cuda)
    f32 = dict(dtype=torch.float32, device=cuda)
    y, hin, G = (torch.empty((1, 128, d), **f32), torch.empty((1, 2, 1, 128, 128), **f32),
                 torch.empty((1, 2, 64, 64), **f32))
    lib = kssd._fwd_library()
    stream = torch.cuda.current_stream().cuda_stream
    args = (xbc.data_ptr(), dth.data_ptr(), S.data_ptr(), D.data_ptr(), y.data_ptr(),
            hin.data_ptr())
    tail = (1, 128, 1, d, 128, 128, 64, xbc.stride(0), xbc.stride(1), stream)
    assert lib.ssd_xbc_fwd(*args, hin.numel(), 1, G.data_ptr(), G.numel(), *tail) == 0
    assert lib.ssd_xbc_fwd(*args, hin.numel(), 1, G.data_ptr(), G.numel() - 1, *tail) != 0
    assert lib.ssd_xbc_fwd(*args, hin.numel() - 1, 1, G.data_ptr(), G.numel(), *tail) != 0
    # the lean forward's scratch holds the states entering chunks 1 .. nc - 1
    lean = hin.numel() // 2
    assert lib.ssd_xbc_fwd(*args, lean, 0, G.data_ptr(), G.numel(), *tail) == 0
    assert lib.ssd_xbc_fwd(*args, hin.numel(), 0, G.data_ptr(), G.numel(), *tail) != 0
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_ssd_mixer_kernel_path_matches_xla(cuda):
    """The mixer at d_model 128 (two heads of 128), L = 100 padded to 128,
    forward and every parameter gradient: 'ssd_fused' (K1, K8, K9, K5)
    against 'xla' on the card."""
    from si_mamba_tpu_torch.models.layers import SSDMixer
    from si_mamba_tpu_torch.ops.kernels import ssd as kssd

    mixer = SSDMixer(128, chunk=64, out_proj_div=2.0, scan_impl="ssd_fused")
    mixer.reset_parameters(torch.Generator().manual_seed(23))
    plain = SSDMixer(128, chunk=64, out_proj_div=2.0, scan_impl="xla")
    plain.load_state_dict(mixer.state_dict())
    mixer, plain = mixer.to(cuda), plain.to(cuda)
    rng = np.random.default_rng(24)
    x, g = _randn(rng, 3, 100, 128, device=cuda), _randn(rng, 3, 100, 128, device=cuda)
    counts = lambda: (kconv.causal_conv1d_silu.launches,  # noqa: E731
                      kssd.ssd_xbc_fwd_states.launches, kssd.ssd_xbc_bwd.launches,
                      kconv.causal_conv1d_silu_bwd.launches)
    before = counts()
    y = mixer(x)
    y.backward(g)
    assert counts() == tuple(c + 1 for c in before)
    y_ref = plain(x)
    y_ref.backward(g)
    _close_to_max(y, y_ref, 1e-5)
    for (name, p), q in zip(mixer.named_parameters(), plain.parameters()):
        assert p.grad is not None, name
        _close_to_max(p.grad, q.grad, 1e-4)


@pytest.mark.cuda
def test_small_ssd_model_kernel_path_matches_xla(cuda):
    from si_mamba_tpu_torch.ops.kernels import ssd as kssd

    cfg = dict(trans_dim=128, encoder_dims=128, depth=2, cls_dim=5, num_group=32,
               group_size=16, drop_path=0.0, mixer="ssd", ssd_chunk=64)
    model = PointMamba(PointMambaConfig(**cfg, scan_impl="ssd_fused")).to(cuda).eval()
    plain = PointMamba(PointMambaConfig(**cfg, scan_impl="xla")).to(cuda).eval()
    plain.load_state_dict(model.state_dict(), strict=True)
    pts = _randn(np.random.default_rng(25), 3, 256, 3, device=cuda)
    k8, k2 = kssd.ssd_xbc_fwd.launches, kscan.selective_scan_fwd.launches
    with torch.inference_mode():
        got = model(pts)
        assert (kssd.ssd_xbc_fwd.launches, kscan.selective_scan_fwd.launches) == (k8 + 2, k2)
        want = plain(pts)
    torch.testing.assert_close(got, want, rtol=2e-3, atol=1e-3 * want.abs().max().item())


def test_ssd_function_gradcheck_in_float64_through_the_plain_path():
    """The plain K8/K9 pair of ``SSDChunkedXbcFn`` in float64 on the CPU, with
    dt and S independent inputs (the kernels take float32 and are held
    against these instead)."""
    from si_mamba_tpu_torch.ops.kernels import ssd as kssd

    rng = np.random.default_rng(26)
    b, l, h, p, n, chunk = 2, 12, 2, 3, 2, 4
    xbc = torch.tensor(rng.standard_normal((b, l, h * p + 2 * n)), dtype=torch.float64)
    dt = torch.tensor(rng.uniform(0.1, 1.0, (b, h, l // chunk, chunk)), dtype=torch.float64)
    S = torch.cumsum(-dt * torch.tensor([0.5, 1.5], dtype=torch.float64)[None, :, None, None],
                     dim=-1)
    D = torch.tensor(rng.standard_normal(h), dtype=torch.float64)
    leaves = [t.clone().requires_grad_() for t in (xbc, dt, S, D)]
    assert torch.autograd.gradcheck(
        lambda *a: kssd.SSDChunkedXbcFn.apply(*a, h * p, chunk), leaves)


# ---------------------------------------------------------------------------
# the split SSD kernels (K6, K7) of the tensor- and sequence-parallel paths
# ---------------------------------------------------------------------------

def _split_case(rng, b, l, h, chunk, device, n=128, p=128, layout="offset"):
    """x as a column view of a wider buffer (``layout='offset'``: 5 columns
    in, so its rows are not 16-byte aligned) or whole (``'tp'``: row stride
    h p, 384 at the tensor-parallel shard's 3 heads, as the x conv makes it),
    B and C as the two halves of one (b, l, 2n) buffer (row stride 2n, as
    ``ssd_mixer_tp`` makes them), dt and S in the kernels' (b, h, nc, q)
    layout."""
    pad = 5 if layout == "offset" else 0
    x = _randn(rng, b, l, h * p + pad, scale=0.5, device=device)[..., pad:]
    bc = _randn(rng, b, l, 2 * n, scale=0.5, device=device)
    dt = torch.nn.functional.softplus(_randn(rng, b, l, h, device=device) - 1.0)
    A = -torch.exp(_randn(rng, h, device=device))
    dth = dt.transpose(1, 2).reshape(b, h, l // chunk, chunk).contiguous()
    S = torch.cumsum(dth * A[None, :, None, None], dim=-1)
    return x, dth, S, bc[..., :n], bc[..., n:]


_SPLIT_CASES = [(2, 512, 3, 256, "offset"), (2, 256, 2, 256, "offset"),
                (1, 384, 3, 128, "offset"), (2, 512, 3, 64, "offset"), (2, 512, 3, 256, "tp")]
_SPLIT_IDS = ["tp_shard", "single_chunk", "nc3", "nc8", "tp_layout"]


@pytest.mark.cuda
@pytest.mark.parametrize("b,l,h,chunk,layout", _SPLIT_CASES, ids=_SPLIT_IDS)
def test_split_fwd_kernels_match_plain(cuda, b, l, h, chunk, layout):
    """The four K6 variants on strided x, B and C: the same y from each
    (the same arithmetic), h_in and h_fin against the plain version."""
    from si_mamba_tpu_torch.ops.kernels import ssd as kssd

    args = (*_split_case(np.random.default_rng(40), b, l, h, chunk, cuda, layout=layout), chunk)
    fns = (kssd.ssd_split_fwd, kssd.ssd_split_fwd_states, kssd.ssd_split_fwd_hfin,
           kssd.ssd_split_fwd_states_hfin)
    before = [f.launches for f in fns]
    y_lean = kssd.ssd_split_fwd(*args)
    y_s, h_in = kssd.ssd_split_fwd_states(*args)
    y_f, h_fin = kssd.ssd_split_fwd_hfin(*args)
    y_sf, h_in2, h_fin2 = kssd.ssd_split_fwd_states_hfin(*args)
    torch.cuda.synchronize()
    assert [f.launches for f in fns] == [n + 1 for n in before]
    for y in (y_s, y_f, y_sf):
        torch.testing.assert_close(y, y_lean, rtol=0, atol=0)
    assert torch.equal(h_in, h_in2) and torch.equal(h_fin, h_fin2)
    y_ref, h_ref, hf_ref = kssd.ssd_split_fwd_ref(*args, emit_states=True, emit_hfin=True)
    assert h_fin.shape == hf_ref.shape == (b, h, 128, 128)
    _close_to_max(y_lean, y_ref, 1e-5)
    _close_to_max(h_in, h_ref, 1e-5)
    _close_to_max(h_fin, hf_ref, 1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("seeded", [False, True], ids=["unseeded", "seeded"])
@pytest.mark.parametrize("b,l,h,chunk,layout", _SPLIT_CASES, ids=_SPLIT_IDS)
def test_split_bwd_kernel_matches_plain(cuda, b, l, h, chunk, layout, seeded):
    """K7 for a strided output gradient, from 0 or seeded with a dh_fin:
    every gradient against the plain version, two runs bitwise equal (the
    head sums of dB and dC run over the heads in order, no atomics)."""
    from si_mamba_tpu_torch.ops.kernels import ssd as kssd

    rng = np.random.default_rng(41)
    x, dth, S, Bm, Cm = _split_case(rng, b, l, h, chunk, cuda, layout=layout)
    dy = _randn(rng, b, l, h * 128 + 3, device=cuda)[..., 3:]
    _, h_in, _ = kssd.ssd_split_fwd_ref(x, dth, S, Bm, Cm, chunk, emit_states=True)
    dh_fin = _randn(rng, b, h, 128, 128, scale=0.1, device=cuda) if seeded else None
    fn = kssd.ssd_split_bwd_seeded if seeded else kssd.ssd_split_bwd
    args = (x, dth, S, Bm, Cm, h_in, dy) + ((dh_fin,) if seeded else ()) + (chunk,)
    before = fn.launches
    got, again = fn(*args), fn(*args)
    torch.cuda.synchronize()
    assert fn.launches == before + 2
    want = kssd.ssd_split_bwd_ref(x, dth, S, Bm, Cm, h_in, dy, chunk, dh_fin=dh_fin)
    for name, a, a2, w in zip(("dx", "ddt", "dS", "dB", "dC"), got, again, want):
        assert a.shape == w.shape, name
        assert torch.equal(a, a2), name
        _close_to_max(a, w, 1e-4)


@pytest.mark.cuda
def test_split_kernels_refuse_scratch_of_another_size(cuda):
    """The C entry points of K6 and K7 check the scratch sizes the wrappers
    hand them, with and without h_fin and the seed."""
    from si_mamba_tpu_torch.ops.kernels import ssd as kssd

    rng = np.random.default_rng(45)
    x, dth, S, Bm, Cm = _split_case(rng, 1, 128, 1, 64, cuda, layout="tp")
    f32 = dict(dtype=torch.float32, device=cuda)
    y, hin, h_fin, G = (torch.empty((1, 128, 128), **f32), torch.empty((1, 2, 1, 128, 128), **f32),
                        torch.empty((1, 1, 128, 128), **f32), torch.empty((1, 2, 64, 64), **f32))
    lib = kssd._fwd_library()
    stream = torch.cuda.current_stream().cuda_stream
    strides = (x.stride(0), x.stride(1), Bm.stride(0), Bm.stride(1), Cm.stride(0), Cm.stride(1))
    geometry = (1, 128, 1, 128, 128, 64)

    def fwd(hin_n, states, hfin_ptr, g_n):
        return lib.ssd_split_fwd(x.data_ptr(), Bm.data_ptr(), Cm.data_ptr(), dth.data_ptr(),
                                 S.data_ptr(), y.data_ptr(), hin.data_ptr(), hin_n, states,
                                 hfin_ptr, G.data_ptr(), g_n, *geometry, *strides, stream)

    assert fwd(hin.numel(), 1, h_fin.data_ptr(), G.numel()) == 0
    assert fwd(hin.numel(), 1, h_fin.data_ptr(), G.numel() - 1) != 0
    assert fwd(hin.numel() - 1, 1, None, G.numel()) != 0
    # the lean forward's scratch holds the states entering chunks 1 .. nc - 1
    assert fwd(hin.numel() // 2, 0, None, G.numel()) == 0
    assert fwd(hin.numel() // 2, 0, h_fin.data_ptr(), G.numel()) == 0
    assert fwd(hin.numel(), 0, h_fin.data_ptr(), G.numel()) != 0

    blib = kssd._bwd_library()
    dy = _randn(rng, 1, 128, 128, device=cuda)
    dx, dbc = torch.empty((1, 128, 128), **f32), torch.empty((1, 128, 256), **f32)
    ddt, dS = torch.empty_like(dth), torch.empty_like(S)
    n_scratch = kssd.bwd_scratch_floats(1, 128, 1, 64, 128, 128)
    scratch = torch.empty(n_scratch + 1, **f32)

    def bwd(scratch_n, seed):
        return blib.ssd_split_bwd(x.data_ptr(), Bm.data_ptr(), Cm.data_ptr(), dth.data_ptr(),
                                  S.data_ptr(), hin.data_ptr(), dy.data_ptr(), seed,
                                  dx.data_ptr(), dbc.data_ptr(), ddt.data_ptr(), dS.data_ptr(),
                                  scratch.data_ptr(), scratch_n, *geometry, *strides,
                                  dy.stride(0), dy.stride(1), stream)

    assert bwd(n_scratch, None) == 0
    assert bwd(n_scratch, h_fin.data_ptr()) == 0
    assert bwd(n_scratch + 1, None) != 0
    assert bwd(n_scratch - 1, h_fin.data_ptr()) != 0
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_split_kernels_reject_what_they_do_not_take(cuda):
    from si_mamba_tpu_torch.ops.kernels import ssd as kssd

    rng = np.random.default_rng(42)
    x, dth, S, Bm, Cm = _split_case(rng, 1, 128, 1, 64, cuda)
    # chunk 32 runs laid out in strips; chunk 12 (refused by JAX too) raises
    dt32, S32 = dth.reshape(1, 1, 4, 32).contiguous(), S.reshape(1, 1, 4, 32).contiguous()
    _close_to_max(kssd.ssd_split_fwd(x, dt32, S32, Bm, Cm, 32),
                  kssd.ssd_split_fwd_ref(x, dt32, S32, Bm, Cm, 32)[0], 1e-5)
    dt12, S12 = (t.reshape(1, 1, 128)[..., :120].reshape(1, 1, 10, 12).contiguous()
                 for t in (dth, S))
    with pytest.raises(ValueError, match="multiple of 8"):
        kssd.ssd_split_fwd(x[:, :120], dt12, S12, Bm[:, :120], Cm[:, :120], 12)
    for n, p in ((64, 128), (192, 128), (128, 192)):  # refused by JAX too
        xs, dth2, S2, Bs, Cs = _split_case(rng, 1, 128, 1, 64, cuda, n=n, p=p)
        with pytest.raises(ValueError, match=f"multiples of 128.*d_state {n} and head_dim {p}"):
            kssd.ssd_split_fwd(xs, dth2, S2, Bs, Cs, 64)
    with pytest.raises(TypeError):
        kssd.ssd_split_fwd(x.double(), dth, S, Bm, Cm, 64)
    with pytest.raises(ValueError, match="CUDA device"):
        kssd.ssd_split_fwd(x, dth, S, Bm.cpu(), Cm, 64)
    with pytest.raises(ValueError, match="unit stride"):
        kssd.ssd_split_fwd(x, dth, S, Bm.transpose(1, 2).contiguous().transpose(1, 2), Cm, 64)


def test_split_functions_gradcheck_in_float64_through_the_plain_path():
    """The plain K6/K7 pairs of ``SSDChunkedSplitFn`` and
    ``SSDChunkedSplitCarryFn`` (the seeded backward) in float64 on the CPU,
    with dt and S independent inputs."""
    from si_mamba_tpu_torch.ops.kernels import ssd as kssd

    rng = np.random.default_rng(43)
    b, l, h, p, n, chunk = 2, 12, 2, 3, 2, 4
    x = torch.tensor(rng.standard_normal((b, l, h * p)), dtype=torch.float64)
    dt = torch.tensor(rng.uniform(0.1, 1.0, (b, h, l // chunk, chunk)), dtype=torch.float64)
    S = torch.cumsum(-dt * torch.tensor([0.5, 1.5], dtype=torch.float64)[None, :, None, None],
                     dim=-1)
    Bm, Cm = (torch.tensor(rng.standard_normal((b, l, n)), dtype=torch.float64)
              for _ in range(2))
    leaves = [t.clone().requires_grad_() for t in (x, dt, S, Bm, Cm)]
    assert torch.autograd.gradcheck(lambda *a: kssd.SSDChunkedSplitFn.apply(*a, chunk), leaves)
    assert torch.autograd.gradcheck(
        lambda *a: kssd.SSDChunkedSplitCarryFn.apply(*a, chunk), leaves)


# ---------------------------------------------------------------------------
# the fused-mixer kernels (K10, K11) and their autograd Function
# ---------------------------------------------------------------------------

def _fused_case(b, l, d_model, seed, device, d_state=16, dt_rank=None):
    """The kernels' inputs as a freshly initialised mixer makes them from a
    seeded x: xz = x @ in_proj, x_proj and dt_proj as they are, conv_w and A
    transposed."""
    from si_mamba_tpu_torch.models.layers import MambaMixer
    from si_mamba_tpu_torch.ops.kernels import fused_mixer as kfm

    mixer = MambaMixer(d_model, d_state=d_state, dt_rank=dt_rank, out_proj_div=2.0)
    mixer.reset_parameters(torch.Generator().manual_seed(seed))
    p = {k: v.detach().to(device) for k, v in mixer.params().items()}
    x = _randn(np.random.default_rng(seed), b, l, d_model, device=device)
    return kfm.kernel_inputs(x @ p["in_proj_w"], p["conv_w"], p["conv_b"], p["x_proj_w"],
                             p["dt_proj_w"], p["dt_proj_b"], -torch.exp(p["A_log"]), p["D"],
                             dt_rank=mixer.dt_rank, d_state=d_state)


def _fused_kernels_against_plain(args, segments_list=(None,), seed=32):
    """K10 lean and with states at each segment count (``None``: the
    kernel's own choice), and K11, against their plain versions: y and
    h_entries within 1e-5 of their max, the states' y equal to the lean y bit
    for bit at the same count, every K11 output within 1e-4 of its max (sums
    over b*l terms in another order), two K11 runs bitwise equal."""
    from si_mamba_tpu_torch.ops.kernels import fused_mixer as kfm

    b, l, two_d = args[0].shape
    y_ref, h_ref = kfm.fused_mixer_fwd_ref(*args, chunk=kfm.CHUNK, emit_states=True)
    for segments in segments_list:
        y_lean = kfm._launch_fwd(args, states=False, segments=segments)[0]
        y, h_entries = kfm._launch_fwd(args, states=True, segments=segments)
        torch.cuda.synchronize()
        assert torch.equal(y, y_lean), segments  # the same arithmetic
        assert h_entries.shape == h_ref.shape == (b, -(-l // kfm.CHUNK), 16, two_d // 2)
        _close_to_max(y, y_ref, 1e-5)
        _close_to_max(h_entries, h_ref, 1e-5)
    g = _randn(np.random.default_rng(seed), b, l, two_d // 2, device=args[0].device)
    before = kfm.fused_mixer_bwd.launches
    got = kfm.fused_mixer_bwd(*args, h_entries, g)
    torch.cuda.synchronize()
    assert kfm.fused_mixer_bwd.launches == before + 1
    want = kfm.fused_mixer_bwd_ref(*args, h_entries, g, chunk=kfm.CHUNK)
    again = kfm.fused_mixer_bwd(*args, h_entries, g)  # no atomics: bitwise the same
    names = ("dxz", "dconv_wt", "dconv_b", "dx_proj", "ddt_proj", "ddtb", "dat", "dd")
    for name, a, w, a2 in zip(names, got, want, again):
        assert a.shape == w.shape, name
        _close_to_max(a, w, 1e-4)
        assert torch.equal(a, a2), name


@pytest.mark.cuda
@pytest.mark.parametrize("b,l,d_model", [(4, 512, 384), (2, 100, 64), (3, 77, 384)])
def test_fused_mixer_fwd_kernels_match_plain(cuda, b, l, d_model):
    from si_mamba_tpu_torch.ops.kernels import fused_mixer as kfm

    args = _fused_case(b, l, d_model, 30, cuda)
    k_lean, k_states = kfm.fused_mixer_fwd.launches, kfm.fused_mixer_fwd_states.launches
    y_lean = kfm.fused_mixer_fwd(*args)
    y, h_entries = kfm.fused_mixer_fwd_states(*args)
    torch.cuda.synchronize()
    assert (kfm.fused_mixer_fwd.launches, kfm.fused_mixer_fwd_states.launches) == (
        k_lean + 1, k_states + 1)
    torch.testing.assert_close(y, y_lean, rtol=0, atol=0)  # the same arithmetic
    y_ref, h_ref = kfm.fused_mixer_fwd_ref(*args, chunk=kfm.CHUNK, emit_states=True)
    assert h_entries.shape == h_ref.shape == (b, -(-l // kfm.CHUNK), 16, 2 * d_model)
    _close_to_max(y, y_ref, 1e-5)
    _close_to_max(h_entries, h_ref, 1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("b,l,d_model", [(4, 512, 384), (2, 100, 64), (2, 77, 384)])
def test_fused_mixer_bwd_kernel_matches_plain(cuda, b, l, d_model):
    """Every output of K11 against the plain backward for a seeded output
    gradient, each within 1e-4 of its max: the weight gradients are sums over
    b*l terms taken per chunk and block, then over the batch."""
    from si_mamba_tpu_torch.ops.kernels import fused_mixer as kfm

    args = _fused_case(b, l, d_model, 31, cuda)
    g = _randn(np.random.default_rng(32), b, l, 2 * d_model, device=cuda)
    _, h_entries = kfm.fused_mixer_fwd_ref(*args, chunk=kfm.CHUNK, emit_states=True)
    before = kfm.fused_mixer_bwd.launches
    got = kfm.fused_mixer_bwd(*args, h_entries, g)
    torch.cuda.synchronize()
    assert kfm.fused_mixer_bwd.launches == before + 1
    want = kfm.fused_mixer_bwd_ref(*args, h_entries, g, chunk=kfm.CHUNK)
    names = ("dxz", "dconv_wt", "dconv_b", "dx_proj", "ddt_proj", "ddtb", "dat", "dd")
    for name, a, w in zip(names, got, want):
        assert a.shape == w.shape, name
        _close_to_max(a, w, 1e-4)
    again = kfm.fused_mixer_bwd(*args, h_entries, g)  # no atomics: bitwise the same
    for name, a, w in zip(names, got, again):
        assert torch.equal(a, w), name


@pytest.mark.cuda
@pytest.mark.parametrize("l", [37, 65, 100])
def test_fused_mixer_kernels_at_ragged_l(cuda, l):
    """L not a multiple of the 16-token chunk, at d_inner 256 and B=2."""
    _fused_kernels_against_plain(_fused_case(2, l, 128, 50, cuda))


@pytest.mark.cuda
@pytest.mark.parametrize("d_model", [64, 192, 384])
def test_fused_mixer_kernels_at_each_width(cuda, d_model):
    """d_inner 128, 384 and 768: clusters of 1, 3 and 6 blocks."""
    _fused_kernels_against_plain(_fused_case(2, 96, d_model, 51, cuda))


@pytest.mark.cuda
@pytest.mark.parametrize("dt_rank", [2, 24, 32])
def test_fused_mixer_kernels_at_each_dt_rank(cuda, dt_rank):
    """dt_rank 2, 24 (the ModelNet40 model's) and 32 (R + 2N = 64, the most
    the kernels take) at d_inner 768."""
    _fused_kernels_against_plain(_fused_case(2, 80, 384, 52, cuda, dt_rank=dt_rank))


@pytest.mark.cuda
def test_fused_mixer_fwd_kernels_with_each_segment_count(cuda):
    """One cloud, each forced segment count (1 the one-pass scan; 16 at
    L = 200 leaves 13 one-chunk segments) and the kernel's own choice: both
    variants against the plain forward and against each other bit for bit."""
    _fused_kernels_against_plain(_fused_case(1, 200, 384, 53, cuda), (1, 2, 3, 16, None))


@pytest.mark.cuda
def test_fused_mixer_kernels_under_strong_decay(cuda):
    """delta |A| of 10 to 100: a state forgets within a step or two, and
    exp(A * sum delta) of a segment underflows to 0."""
    args = list(_fused_case(1, 130, 192, 54, cuda))
    args[5] = args[5] + 3.0  # dt bias: delta about 3
    args[6] = args[6] * 20.0  # A 20x more negative
    _fused_kernels_against_plain(tuple(args), (None, 1, 4))


@pytest.mark.cuda
def test_fused_mixer_segment_choice_follows_the_batch(cuda):
    """K10 cuts L into segments only while the grid leaves the card idle: at
    one cloud, not at the train batch."""
    from si_mamba_tpu_torch.ops.kernels import fused_mixer as kfm

    lib = kfm._fwd_library()
    assert lib.fused_mixer_fwd_segments(1, 512, 768) > 1
    assert lib.fused_mixer_fwd_segments(32, 512, 768) == 1


@pytest.mark.cuda
def test_fused_mixer_bwd_reports_its_co_resident_clusters(cuda):
    """K11's occupancy query: at least one cluster of d_inner / 128 blocks
    fits the card, no more than its SMs hold one block each, and a width the
    kernel does not take is an error."""
    from si_mamba_tpu_torch.ops.kernels import fused_mixer as kfm

    lib = kfm._bwd_library()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for d_inner in (128, 768, 1024):
        assert 1 <= lib.fused_mixer_bwd_max_active_clusters(d_inner) <= sms // (d_inner // 128)
    assert lib.fused_mixer_bwd_max_active_clusters(100) < 0
    assert lib.fused_mixer_bwd_max_active_clusters(2048) < 0


@pytest.mark.cuda
def test_fused_mixer_kernels_refuse_a_wide_x_proj_before_launching(cuda):
    """dt_rank 34 at d_state 16 (R + 2N = 66, wider than the tuned kernels'
    64): every wrapper launches its any-shape variant once, nothing of the
    tuned kernels, and each result holds against its plain version; a
    d_inner that is no multiple of 128, which the JAX kernel refuses too,
    raises before any launch."""
    from si_mamba_tpu_torch.ops.kernels import fused_mixer as kfm

    args = _fused_case(1, 32, 64, 55, cuda, dt_rank=34)
    tuned = lambda: (kfm.fused_mixer_fwd.launches,  # noqa: E731
                     kfm.fused_mixer_fwd_states.launches, kfm.fused_mixer_bwd.launches)
    anys = lambda: tuple(kfm.ANY_LAUNCHES[n].launches for n in (  # noqa: E731
        "fused_mixer_fwd_any", "fused_mixer_fwd_states_any", "fused_mixer_bwd_any"))
    before, before_any = tuned(), anys()
    g = _randn(np.random.default_rng(56), 1, 32, 128, device=cuda)
    y = kfm.fused_mixer_fwd(*args)
    y_s, h = kfm.fused_mixer_fwd_states(*args)
    grads = kfm.fused_mixer_bwd(*args, h, g)
    assert tuned() == before and anys() == tuple(c + 1 for c in before_any)
    y_ref, h_ref = kfm.fused_mixer_fwd_ref(*args, chunk=kfm.CHUNK, emit_states=True)
    _close_to_max(y, y_ref, 1e-5)
    assert torch.equal(y, y_s)
    _close_to_max(h, h_ref, 1e-5)
    for got, want in zip(grads, kfm.fused_mixer_bwd_ref(*args, h, g, chunk=kfm.CHUNK)):
        _close_to_max(got, want, 1e-4)
    narrow = (args[0][..., :192].contiguous(), *args[1:])
    with pytest.raises(ValueError, match="d_inner % 128 == 0"):
        kfm.fused_mixer_fwd(*narrow)
    assert tuned() == before


@pytest.mark.cuda
def test_fused_mixer_grads_match_seq(cuda):
    """The mixer with scan_impl='fused' (K10 with states, K11 through
    ``FusedMixerFn``, x_proj and dt_proj gradients from K11) against 'seq': output and
    every parameter gradient; without a gradient it takes the lean K10."""
    from si_mamba_tpu_torch.models.layers import MambaMixer
    from si_mamba_tpu_torch.ops.kernels import fused_mixer as kfm

    mixer = MambaMixer(128, out_proj_div=2.0, scan_impl="fused")
    mixer.reset_parameters(torch.Generator().manual_seed(33))
    plain = MambaMixer(128, out_proj_div=2.0, scan_impl="seq")
    plain.load_state_dict(mixer.state_dict())
    mixer, plain = mixer.to(cuda), plain.to(cuda)
    rng = np.random.default_rng(34)
    x, g = _randn(rng, 3, 90, 128, device=cuda), _randn(rng, 3, 90, 128, device=cuda)
    counts = lambda: (kfm.fused_mixer_fwd.launches,  # noqa: E731
                      kfm.fused_mixer_fwd_states.launches, kfm.fused_mixer_bwd.launches)
    k10, k10s, k11 = counts()
    y = mixer(x)
    y.backward(g)
    assert counts() == (k10, k10s + 1, k11 + 1)
    y_ref = plain(x)
    y_ref.backward(g)
    _close_to_max(y, y_ref, 1e-5)
    for (name, p), q in zip(mixer.named_parameters(), plain.parameters()):
        assert p.grad is not None, name
        _close_to_max(p.grad, q.grad, 1e-4)
    with torch.no_grad():
        _close_to_max(mixer(x), y_ref, 1e-5)
    assert counts() == (k10 + 1, k10s + 1, k11 + 1)


@pytest.mark.cuda
def test_fused_mixer_kernels_reject_what_they_do_not_take(cuda):
    """d_state 8 is a shape 'fused' takes (d_inner % 128 == 0, d_state <=
    32) that the tuned kernels are not built for: on CUDA it runs their
    any-shape variant, never the plain path, and holds against 'seq';
    d_state 33 (the JAX kernel refuses it too) raises; float64 raises at the
    kernel wrapper."""
    from si_mamba_tpu_torch.models.layers import MambaMixer
    from si_mamba_tpu_torch.ops.kernels import fused_mixer as kfm

    mixer = MambaMixer(64, d_state=8, scan_impl="fused")
    mixer.reset_parameters(torch.Generator().manual_seed(35))
    plain = MambaMixer(64, d_state=8, scan_impl="seq")
    plain.load_state_dict(mixer.state_dict())
    mixer, plain = mixer.to(cuda), plain.to(cuda)
    x = _randn(np.random.default_rng(35), 1, 16, 64, device=cuda)
    before = kfm.fused_mixer_fwd.launches
    before_any = kfm.ANY_LAUNCHES["fused_mixer_fwd_any"].launches
    with torch.no_grad():
        _close_to_max(mixer(x), plain(x), 1e-5)
    assert kfm.fused_mixer_fwd.launches == before
    assert kfm.ANY_LAUNCHES["fused_mixer_fwd_any"].launches == before_any + 1
    with pytest.raises(ValueError, match="d_state <= 32"):
        with torch.no_grad():
            MambaMixer(64, d_state=33, scan_impl="fused").to(cuda)(x)
    args = _fused_case(1, 16, 64, 36, cuda)
    with pytest.raises(TypeError):
        kfm.fused_mixer_fwd(args[0].double(), *args[1:])


@pytest.mark.cuda
def test_small_fused_model_kernel_path_matches_seq(cuda):
    from si_mamba_tpu_torch.ops.kernels import fused_mixer as kfm

    cfg = dict(trans_dim=64, encoder_dims=64, depth=2, cls_dim=5, num_group=32,
               group_size=16, drop_path=0.0)
    model = PointMamba(PointMambaConfig(**cfg, scan_impl="fused")).to(cuda).eval()
    plain = PointMamba(PointMambaConfig(**cfg, scan_impl="seq")).to(cuda).eval()
    plain.load_state_dict(model.state_dict(), strict=True)
    pts = _randn(np.random.default_rng(37), 3, 256, 3, device=cuda)
    k10, k2 = kfm.fused_mixer_fwd.launches, kscan.selective_scan_fwd.launches
    with torch.inference_mode():
        got = model(pts)
        assert (kfm.fused_mixer_fwd.launches, kscan.selective_scan_fwd.launches) == (k10 + 2, k2)
        want = plain(pts)
    torch.testing.assert_close(got, want, rtol=2e-3, atol=1e-3 * want.abs().max().item())


def test_fused_mixer_function_gradcheck_in_float64_through_the_plain_path():
    """The plain K10/K11 pair of ``FusedMixerFn`` in float64 on the CPU (the
    kernels take float32 and are held against these instead)."""
    from si_mamba_tpu_torch.ops.kernels import fused_mixer as kfm

    rng = np.random.default_rng(38)
    b, l, di, n, r = 2, 9, 3, 2, 2
    mk = lambda *s, scale=1.0: torch.tensor(rng.standard_normal(s) * scale,  # noqa: E731
                                            dtype=torch.float64)
    leaves = [mk(b, l, 2 * di), mk(4, di, scale=0.5), mk(di, scale=0.1),
              mk(di, r + 2 * n, scale=0.5), mk(r, di, scale=0.5), mk(di, scale=0.5),
              -torch.exp(mk(n, di)), mk(di)]
    leaves = [t.requires_grad_() for t in leaves]
    assert torch.autograd.gradcheck(lambda *a: kfm.FusedMixerFn.apply(*a, True), leaves)


@pytest.mark.cuda
def test_cli_finetunes_and_tests_on_the_card(cuda, tmp_path, monkeypatch):
    """The harness CLI at a small size on the card: a finetune (2 epochs of 2
    steps, a validation after each) and --test of its ckpt-last.pth. Each
    step launches the conv forward and backward and the training scan
    forward and backward once a block, each eval forward the conv and the
    lean scan once a block, and no run any other kernel."""
    from chip_smoke import write_modelnet_tree
    from si_mamba_tpu_torch.ops.kernels import ssd as kssd
    from si_mamba_tpu_torch.train import cli

    wrappers = {"k1": kconv.causal_conv1d_silu, "k2": kscan.selective_scan_fwd,
                "k3": kscan.selective_scan_fwd_residuals, "k4": kscan.selective_scan_bwd,
                "k5": kconv.causal_conv1d_silu_bwd, "k8": kssd.ssd_xbc_fwd}

    def counts():
        return {k: w.launches for k, w in wrappers.items()}

    rng = np.random.default_rng(41)
    data = write_modelnet_tree(tmp_path / "mn", {
        "train": [(i % 4, rng.standard_normal((1300, 6)).astype(np.float32)) for i in range(16)],
        "test": [(i % 4, rng.standard_normal((1300, 6)).astype(np.float32)) for i in range(6)]},
        n_classes=4)
    (tmp_path / "mn.yaml").write_text(f"NAME: ModelNet\nDATA_PATH: {data}\nN_POINTS: 1300\n"
                                      f"NUM_CATEGORY: 40\nUSE_NORMALS: FALSE\n")
    cfg = tmp_path / "small.yaml"
    cfg.write_text(
        "optimizer: {type: AdamW, kwargs: {lr: 0.001, weight_decay: 0.05}}\n"
        "scheduler: {type: CosLR, kwargs: {epochs: 3, initial_epochs: 1}}\n"
        "dataset:\n" + "".join(f"  {s}: {{_base_: {tmp_path}/mn.yaml, others: {{subset: {sub}}}}}\n"
                               for s, sub in (("train", "train"), ("val", "test"),
                                              ("test", "test"))) +
        "model: {NAME: PointMamba, trans_dim: 64, encoder_dims: 64, depth: 2, cls_dim: 4,\n"
        "        num_group: 32, group_size: 16, knn_graph: 8}\n"
        "npoints: 1024\ntotal_bs: 8\nmax_epoch: 1\ngrad_norm_clip: 10\n")
    monkeypatch.chdir(tmp_path)
    before = counts()
    state, _ = cli.main(["--config", str(cfg), "--num_workers", "2"])  # the device: cuda
    train = {k: v - before[k] for k, v in counts().items()}
    assert state.step == 4 and next(state.model.parameters()).is_cuda
    # 4 steps; 2 validations of one forward (6 clouds at the batch of 16)
    assert train == {"k1": 2 * (4 + 2), "k2": 2 * 2, "k3": 2 * 4, "k4": 2 * 4, "k5": 2 * 4,
                     "k8": 0}
    last = tmp_path / "experiments" / "small" / "default" / "ckpt-last.pth"
    before = counts()
    acc = cli.main(["--config", str(cfg), "--test", "--ckpts", str(last), "--exp_name", "t"])
    assert {k: v - before[k] for k, v in counts().items()} == {
        "k1": 2, "k2": 2, "k3": 0, "k4": 0, "k5": 0, "k8": 0}
    scalars = (tmp_path / "experiments" / "small" / "default" / "scalars.jsonl").read_text()
    val = [json.loads(line)["value"] for line in scalars.splitlines()
           if json.loads(line)["tag"] == "Metric/ACC"]
    assert acc == val[-1]


# ---------------------------------------------------------------------------
# perf mode: the bf16 variants of K1-K5
# ---------------------------------------------------------------------------

def _bf16_ulps(got, want, floor=1e-2):
    """The largest |got - want| in bf16 ulps of want (8 significant bits),
    each ulp taken at least at ``floor`` of max|want|."""
    got, want = got.float(), want.float()
    mag = torch.clamp_min(want.abs(), floor * want.abs().max().item())
    return ((got - want).abs() / torch.exp2(torch.floor(torch.log2(mag)) - 7)).max().item()


def _bf16_counts():
    """The bf16 K1, K5 and the Hopper bf16 scan body's K2, K3, K4 counts."""
    sm90 = kscan.SM90_LAUNCHES
    return (kconv.causal_conv1d_silu_bf16.launches, kconv.causal_conv1d_silu_bwd_bf16.launches,
            sm90["selective_scan_fwd_sm90_bf16"].launches,
            sm90["selective_scan_fwd_residuals_sm90_bf16"].launches,
            sm90["selective_scan_bwd_sm90_bf16"].launches)


def _fp32_counts():
    return (kconv.causal_conv1d_silu.launches, kconv.causal_conv1d_silu_bwd.launches,
            kscan.selective_scan_fwd.launches, kscan.selective_scan_fwd_residuals.launches,
            kscan.selective_scan_bwd.launches)


@pytest.mark.cuda
@pytest.mark.parametrize("b,l,d,row,off,vec", [
    (2, 512, 768, 1536, 0, 4),   # the Mamba-1 view: K1 and K5 (4, 4) 8-byte accesses
    (2, 65, 200, 400, 0, 4),     # ragged L, 50 vectors a row
    (3, 37, 24, 50, 1, 1),       # an odd address: one channel a thread, K5 (1, 1)
    (1, 130, 130, 262, 2, 2),    # D % 4 != 0: K5's masked edge; K1 4-byte accesses
    (2, 512, 1024, 1798, 768, 2),  # the SSD view: K1 4-byte accesses, K5 (2, 4)
    (32, 512, 384, 384, 0, 4),   # the tensor-parallel SSD x shard
    (32, 512, 256, 256, 0, 4),   # the tensor-parallel SSD B|C
    (1, 512, 768, 1536, 0, 4),   # one cloud
    (3, 100, 1024, 1798, 768, 2),  # L not a multiple of any tile
])
def test_bf16_conv_kernels_match_plain(cuda, b, l, d, row, off, vec):
    """The bf16 K1 and K5 on a column view of a bf16 buffer: y and dx within
    one bf16 ulp of the plain versions (each rounds one fp32 sum, in another
    order), dw and db fp32 within 1e-4 of their max; two backward runs
    bitwise equal; only the bf16 counts move."""
    rng = np.random.default_rng(b * l + off)
    buf = _randn(rng, b, l, row, device=cuda).to(torch.bfloat16)
    x = buf[..., off:off + d]
    w, bias = _randn(rng, d, 4, scale=0.5, device=cuda), _randn(rng, d, scale=0.1, device=cuda)
    g = _randn(rng, b, l, d, device=cuda).to(torch.bfloat16)
    assert kconv.fwd_plan(x).vec == vec
    before, fp32 = _bf16_counts(), _fp32_counts()
    y = kconv.causal_conv1d_silu_bf16(x, w, bias)
    got = kconv.causal_conv1d_silu_bwd_bf16(x, w, bias, g)
    again = kconv.causal_conv1d_silu_bwd(x, w, bias, g)
    torch.cuda.synchronize()
    assert [a - c for a, c in zip(_bf16_counts(), before)] == [1, 2, 0, 0, 0]
    assert _fp32_counts() == fp32
    assert y.dtype == got[0].dtype == torch.bfloat16
    assert _bf16_ulps(y, kconv.causal_conv1d_ref(x, w, bias)) <= 1
    want = kconv.causal_conv1d_silu_bwd_ref(x, w, bias, g)
    assert _bf16_ulps(got[0], want[0]) <= 1
    for a, r in zip(got[1:], want[1:]):
        assert a.dtype == torch.float32
        _close_to_max(a, r, 1e-4)
    assert all(torch.equal(a, c) for a, c in zip(got, again))


def _bf16_scan_against_plain(args, g, segments=None):
    """The Hopper bf16 body's K2, K3 and K4 on ``args`` against the plain
    versions at chip_smoke.bf16_kernel_phase's tolerances: y within one bf16
    ulp of the plain version (floor 1e-2 of max|y|), K3's y equal to K2's
    and its fp32 entry states (every ``kscan.SM90_TILE`` steps) within 1e-4
    of the plain ones; K4's bf16 gradients (du, ddelta, dz, dB, dC) within 2
    ulps at a floor of 2e-2 of their max, its fp32 ones (dA, dD, ddelta_bias)
    within 1e-3 of their max, two runs bitwise equal; only the body's counts
    move (K2 and K3 once, K4 twice)."""
    D, z, dt_bias = args[5], args[6], args[7]
    before, fp32 = _bf16_counts(), _fp32_counts()
    y = kscan._launch_fwd(*args, residuals=False, segments=segments)[0]
    y3, h3 = kscan._launch_fwd(*args, residuals=True, segments=segments)
    got = kscan.selective_scan_bwd_bf16(*args, g, h3)
    again = kscan.selective_scan_bwd(*args, g, h3)
    torch.cuda.synchronize()
    assert [a - c for a, c in zip(_bf16_counts(), before)] == [0, 0, 1, 1, 2]
    assert _fp32_counts() == fp32
    assert y.dtype == torch.bfloat16 and h3.dtype == torch.float32 and torch.equal(y3, y)
    assert h3.shape[1] == -(-args[0].shape[1] // kscan.SM90_TILE)
    assert _bf16_ulps(y, kscan.selective_scan_ref(*args[:5], D=D, z=z, delta_bias=dt_bias)) <= 1
    _close_to_max(h3, kscan.selective_scan_fwd_residuals_ref(*args, tile=kscan.SM90_TILE)[1],
                  1e-4)
    want = kscan.selective_scan_bwd_ref(*args, g, h3, tile=kscan.SM90_TILE)
    for a, r, inp in zip(got, want, args):
        assert a.dtype == inp.dtype
        if a.dtype == torch.bfloat16:
            assert _bf16_ulps(a, r, floor=2e-2) <= 2
        else:
            _close_to_max(a, r, 1e-3)
    assert all(torch.equal(a, c) for a, c in zip(got, again))


def _bf16_scan_case(rng, b, l, d, device, xoff=3, n=16):
    """bf16 scan operands: B and C column views of a bf16 x_dbl ``xoff``
    columns in (3: rows the tensor maps cannot read as they lie, so the
    wrapper copies them; 24: perf mode's x_dbl, read in place), z the second
    half of a bf16 xz; fp32 A, D, dt_bias; a bf16 output gradient."""
    bf = lambda t: t.to(torch.bfloat16)  # noqa: E731
    x_dbl = bf(_randn(rng, b, l, xoff + 2 * n, device=device))
    xz = bf(_randn(rng, b, l, 2 * d, device=device))
    u, delta, g = (bf(_randn(rng, b, l, d, device=device)) for _ in range(3))
    A = -torch.exp(_randn(rng, d, n, device=device))
    D, dt_bias = _randn(rng, d, device=device), _randn(rng, d, scale=0.1, device=device)
    return (u, delta, A, x_dbl[..., xoff:xoff + n], x_dbl[..., xoff + n:], D, xz[..., d:],
            dt_bias), g


@pytest.mark.cuda
@pytest.mark.parametrize("b,l,d", [(2, 512, 768), (1, 100, 200), (3, 37, 96)])
def test_bf16_scan_kernels_match_plain(cuda, b, l, d):
    """The bf16 K2, K3 and K4 on the Hopper body (B and C column views of a
    bf16 x_dbl the wrapper copies) against the plain versions."""
    _bf16_scan_against_plain(*_bf16_scan_case(np.random.default_rng(l + d), b, l, d, cuda))


@pytest.mark.cuda
@pytest.mark.parametrize("b,l,d", [
    (1, 512, 768), (2, 512, 768), (20, 512, 768), (64, 512, 768),  # serving and train sizes
    (3, 26, 768), (2, 100, 768),   # ragged L (the legacy MAE's 26, no multiple of 8 or 16)
    (16, 256, 768),                # the part-segmentation model
    (2, 64, 72),                   # d no multiple of the 64-channel blocks
])
def test_bf16_scan_kernels_at_path_shapes(cuda, b, l, d):
    """The Hopper body at the paths' shapes on perf mode's views (x_dbl
    dt_rank 24 + 2 d_state wide, read in place by the tensor maps)."""
    rng = np.random.default_rng(b * l + d)
    _bf16_scan_against_plain(*_bf16_scan_case(rng, b, l, d, cuda, xoff=24))


@pytest.mark.cuda
@pytest.mark.parametrize("segments", [1, 2, 3, 16])
def test_bf16_scan_fwd_with_each_segment_count(cuda, segments):
    """The Hopper body's segmented forward at a forced segment count (1 the
    one-pass scan; 16 at L=200 leaves 13 one-tile segments)."""
    _bf16_scan_against_plain(*_bf16_scan_case(np.random.default_rng(41), 2, 200, 96, cuda),
                             segments=segments)


@pytest.mark.cuda
def test_bf16_scan_kernels_under_strong_decay(cuda):
    """delta |A| of 10 to 100 at bf16: a state forgets within a step or two,
    and exp(A * sum delta) of a segment underflows to 0."""
    rng = np.random.default_rng(42)
    args, g = _bf16_scan_case(rng, 2, 130, 72, cuda, xoff=24)
    delta = (_randn(rng, 2, 130, 72, scale=2.0, device=cuda) + 3.0).to(torch.bfloat16)
    A = -torch.exp(_randn(rng, 72, 16, scale=0.5, device=cuda) + 2.5)
    args = (args[0], delta, A, *args[3:])
    for segments in (None, 1, 4):
        _bf16_scan_against_plain(args, g, segments=segments)


@pytest.mark.cuda
def test_bf16_scan_segment_choice_follows_the_batch(cuda):
    """The Hopper body cuts L into segments by the earlier forward's rule: at
    one cloud, not at the train batch."""
    lib = kscan._sm90_library()
    for b in (1, 20, 32, 64):
        assert lib.scan_sm90_segments(b, 512, 768) == \
            kscan._fwd_library().selective_scan_fwd_segments(b, 512, 768)
    assert lib.scan_sm90_segments(1, 512, 768) > 1 and lib.scan_sm90_segments(32, 512, 768) == 1


@pytest.mark.cuda
def test_bf16_model_kernel_path_matches_plain(cuda):
    """A small perf-mode model (bf16, subspace) on the card: an eval forward
    launches only the bf16 K1 and K2, a train step only the bf16 K1, K3, K4
    and K5, and the eval logits are within 3e-2 of the max of the plain route
    ('seq': the plain conv with bf16 weights, the sequential scan)."""
    cfg = dict(trans_dim=64, encoder_dims=64, depth=2, cls_dim=8, num_group=32,
               group_size=16, drop_path=0.0, cls_head_dropout=0.0, dtype="bfloat16",
               spectral_method="subspace")
    model = PointMamba(PointMambaConfig(**cfg), generator=torch.Generator().manual_seed(3))
    model = model.to(cuda)
    plain = PointMamba(PointMambaConfig(**cfg, scan_impl="seq")).to(cuda)
    plain.load_state_dict(model.state_dict())
    pts = _randn(np.random.default_rng(4), 4, 512, 3, device=cuda)
    before, fp32 = _bf16_counts(), _fp32_counts()
    with torch.no_grad():
        logits = model.eval()(pts)
        want = plain.eval()(pts)
    torch.cuda.synchronize()
    assert [a - c for a, c in zip(_bf16_counts(), before)] == [2, 0, 2, 0, 0]
    assert logits.dtype == torch.bfloat16
    _close_to_max(logits.float(), want.float(), 3e-2)
    before = _bf16_counts()
    loss = model.train()(pts).float().square().mean()
    loss.backward()
    torch.cuda.synchronize()
    assert [a - c for a, c in zip(_bf16_counts(), before)] == [2, 2, 0, 2, 2]
    assert _fp32_counts() == fp32
    assert all(p.grad is not None and p.grad.dtype == torch.float32 and
               torch.isfinite(p.grad).all() for p in model.parameters())


# ---------------------------------------------------------------------------
# the SSD presets: the bf16 variants of K8/K9 and K6/K7
# ---------------------------------------------------------------------------

def _ssd_bf16_counts():
    """({bf16 count: launches} of the bf16 wrappers and the Hopper bf16
    body's '_sm90' counts, by the fp32 name; {fp32 count: launches})."""
    from si_mamba_tpu_torch.ops.kernels import ssd as kssd

    names = ("ssd_xbc_fwd", "ssd_xbc_fwd_states", "ssd_xbc_bwd", "ssd_split_fwd",
             "ssd_split_fwd_states", "ssd_split_fwd_hfin", "ssd_split_fwd_states_hfin",
             "ssd_split_bwd", "ssd_split_bwd_seeded")
    sm90 = {n + "_sm90": kssd.VARIANT_LAUNCHES[n + "_sm90_bf16"].launches
            for n in ("ssd_xbc_fwd", "ssd_xbc_fwd_states", "ssd_xbc_fwd_hfin",
                      "ssd_xbc_fwd_states_hfin", "ssd_xbc_bwd", "ssd_xbc_bwd_seeded")}
    return ({n: getattr(kssd, n + "_bf16").launches for n in names} | sm90,
            {n: getattr(kssd, n).launches for n in names})


def _hold_bf16(name, got, want):
    """chip_smoke.py's bf16 tolerances: a bf16 output within 2 bf16 ulps of
    the plain version's at a floor of 2e-2 of its max; an fp32 output (states,
    ddt, dS, dD) within 1e-3 of its max."""
    assert got.dtype == want.dtype and got.shape == want.shape, name
    assert torch.isfinite(got.float()).all(), name
    if got.dtype == torch.bfloat16:
        assert _bf16_ulps(got, want, floor=2e-2) <= 2, (name, _bf16_ulps(got, want, 2e-2))
    else:
        _close_to_max(got, want, 1e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("b,l,h,chunk,layout,decay", [
    (1, 64, 1, 64, "conv", 1.0),      # nc 1
    (3, 256, 3, 128, "view", 1.0),    # nc 2, rows 4-byte aligned only
    (3, 512, 6, 256, "conv", 1.0),    # the SSD classifier's chunk and heads
    (1, 256, 6, 64, "view", 30.0),    # nc 4, strong decay
    (1, 2048, 3, 128, "conv", 1.0),   # nc 16
])
def test_ssd_bf16_kernels_match_plain(cuda, b, l, h, chunk, layout, decay):
    """The bf16 K8 (lean and with states) and K9 against their plain versions
    at bf16: the lean y bitwise equal to the states variant's, two K9 runs
    bitwise equal (dB and dC summed over the heads in a fixed order in fp32,
    rounded once), each launch counted on the Hopper bf16 body's '_sm90'
    count (every chunk here is one it serves) and none on the fp32 ones."""
    from si_mamba_tpu_torch.ops.kernels import ssd as kssd

    rng = np.random.default_rng(61)
    d = h * 128
    if layout == "view":  # 6 columns in: rows 12 bytes off a 16-byte boundary
        xbc = _randn(rng, b, l, d + 262, scale=0.5, device=cuda).to(torch.bfloat16)[..., 6:]
    else:
        xbc = _ssd_mixer_xbc(rng, b, l, h, layout, cuda).to(torch.bfloat16)
    dt = torch.nn.functional.softplus(_randn(rng, b, l, h, device=cuda) - 1.0)
    A = -decay * torch.exp(_randn(rng, h, device=cuda))
    dth = dt.transpose(1, 2).reshape(b, h, l // chunk, chunk).contiguous()
    S = torch.cumsum(dth * A[None, :, None, None], dim=-1)
    D = _randn(rng, h, device=cuda)
    dy = _randn(rng, b, l, d + 2, device=cuda).to(torch.bfloat16)[..., 2:]
    before, fp32 = _ssd_bf16_counts()
    y_lean = kssd.ssd_xbc_fwd(xbc, dth, S, D, d, chunk)
    y, h_in = kssd.ssd_xbc_fwd_states_bf16(xbc, dth, S, D, d, chunk)
    got = kssd.ssd_xbc_bwd_bf16(xbc, dth, S, D, h_in, dy, d, chunk)
    again = kssd.ssd_xbc_bwd(xbc, dth, S, D, h_in, dy, d, chunk)
    torch.cuda.synchronize()
    after, fp32_after = _ssd_bf16_counts()
    assert fp32_after == fp32
    assert {k: after[k] - before[k] for k in after if after[k] != before[k]} == {
        "ssd_xbc_fwd_sm90": 1, "ssd_xbc_fwd_states_sm90": 1, "ssd_xbc_bwd_sm90": 2}
    torch.testing.assert_close(y, y_lean, rtol=0, atol=0)
    for a, w in zip(got, again):
        torch.testing.assert_close(a, w, rtol=0, atol=0)
    y_ref, h_ref = kssd.ssd_xbc_fwd_ref(xbc, dth, S, D, d, chunk, emit_states=True)
    _hold_bf16("y", y, y_ref)
    _hold_bf16("h_in", h_in, h_ref)
    want = kssd.ssd_xbc_bwd_ref(xbc, dth, S, D, h_in, dy, d, chunk)
    for name, a, w in zip(("dxbc", "ddt", "dS", "dD"), got, want):
        _hold_bf16(name, a, w)


def _sm90_operands(b, l, chunk, device):
    """The bf16 SSD presets' K8/K9 operands at batch b, length l and chunk:
    6 heads of 128, d_state 128, xbc a mixer's conv output, dy and a seed."""
    rng = np.random.default_rng(chunk + b + l)
    h, d = 6, 768
    xbc = _ssd_mixer_xbc(rng, b, l, h, "conv", device).to(torch.bfloat16)
    dt = torch.nn.functional.softplus(_randn(rng, b, l, h, device=device) - 1.0)
    A = -torch.exp(_randn(rng, h, device=device))
    dth = dt.transpose(1, 2).reshape(b, h, l // chunk, chunk).contiguous()
    S = torch.cumsum(dth * A[None, :, None, None], dim=-1)
    D = _randn(rng, h, device=device)
    dy = _randn(rng, b, l, d, device=device).to(torch.bfloat16)
    dh_fin = _randn(rng, b, h, 128, 128, scale=0.1, device=device)
    return (xbc, dth, S, D, d, chunk), dy, dh_fin


@pytest.mark.cuda
@pytest.mark.parametrize("b,l,chunk", [(8, 512, 256), (8, 512, 128), (4, 512, 64), (4, 384, 192),
                                       (128, 512, 128), (128, 256, 128)])
def test_ssd_sm90_body_holds_at_the_preset_shapes(cuda, b, l, chunk):
    """The Hopper bf16 body at the bf16 SSD presets' geometry (6 heads of
    128, d_state 128; chunk 256 of finetune_modelnet_ssd_fused.yaml, 128 of
    pretrain_ssd_fused.yaml, 64 the smallest it serves; 192 at L 384) on a
    conv output of a mixer, at each block shape of bwd_dbc on an H100's 132
    SMs: half of n a block at B 8 and 4, two strips and all of n at B 128, L
    512, one strip and all of n at B 128, L 256. Every K8 (lean, with states,
    with h_fin, with both) and K9 (from 0, seeded) against their plain
    versions at bf16 (a bf16 output within 2 bf16 ulps at a floor of 2e-2 of
    max, at B 128 against the fp64 truth as chip_smoke.py holds the
    pretraining shapes; h_in, h_fin, ddt, dS, dD within 1e-3 of max), each K9
    twice bitwise equal, every launch on the body's '_sm90' counts; its
    scratch the size the C side carves."""
    from chip_smoke import _f64, _hold_bf16_truth
    from si_mamba_tpu_torch.ops.kernels import ssd as kssd

    args, dy, dh_fin = _sm90_operands(b, l, chunk, cuda)
    xbc, dth, S, D, d, _ = args
    lib = kssd._sm90_library()
    for seeded in (0, 1):
        assert lib.ssd_sm90_bwd_scratch_floats(b, l, 6, chunk, seeded) == \
            kssd.sm90_bwd_scratch_floats(b, l, 6, chunk, bool(seeded))
    before, _ = _ssd_bf16_counts()
    y = kssd.ssd_xbc_fwd_bf16(*args)
    y8, h_in = kssd.ssd_xbc_fwd_states_bf16(*args)
    yf, h_fin = kssd.ssd_xbc_fwd_hfin_bf16(*args)
    y8f, h_in8f, h_fin8f = kssd.ssd_xbc_fwd_states_hfin_bf16(*args)
    bargs = (xbc, dth, S, D, h_in, dy, d, chunk)
    runs = {seed is not None: [kssd.ssd_xbc_bwd_bf16(*bargs) if seed is None else
                               kssd.ssd_xbc_bwd_seeded_bf16(*bargs[:6], seed, d, chunk)
                               for _ in range(2)] for seed in (None, dh_fin)}
    torch.cuda.synchronize()
    after, _ = _ssd_bf16_counts()
    assert {k: after[k] - before[k] for k in after if after[k] != before[k]} == {
        "ssd_xbc_fwd_sm90": 1, "ssd_xbc_fwd_states_sm90": 1, "ssd_xbc_fwd_hfin_sm90": 1,
        "ssd_xbc_fwd_states_hfin_sm90": 1, "ssd_xbc_bwd_sm90": 2, "ssd_xbc_bwd_seeded_sm90": 2}
    assert all(torch.equal(y, other) for other in (y8, yf, y8f))
    assert torch.equal(h_in, h_in8f) and torch.equal(h_fin, h_fin8f)
    for got, again in runs.values():
        assert all(torch.equal(a, w) for a, w in zip(got, again))
    y_ref, h_ref, hf_ref = kssd.ssd_xbc_fwd_ref(*args, emit_states=True, emit_hfin=True)

    def hold16(name, got, want, truth):
        if b == 128:
            _hold_bf16_truth(name, got, want, truth())
        else:
            _hold_bf16(name, got, want)

    hold16("y", y, y_ref, lambda: kssd.ssd_xbc_fwd_ref(*_f64(args))[0])
    _hold_bf16("h_in", h_in, h_ref)
    _hold_bf16("h_fin", h_fin, hf_ref)
    for seed in (None, dh_fin):
        got = runs[seed is not None][0]
        want = kssd.ssd_xbc_bwd_ref(*bargs, dh_fin=seed)
        tag = "seeded " if seed is not None else ""
        hold16(tag + "dxbc", got[0], want[0], lambda: kssd.ssd_xbc_bwd_ref(
            *_f64(bargs), dh_fin=None if seed is None else seed.double())[0])
        for name, a, w in zip(("ddt", "dS", "dD"), got[1:], want[1:]):
            _hold_bf16(tag + name, a, w)


@pytest.mark.cuda
def test_ssd_sm90_bits_do_not_depend_on_the_batch(cuda):
    """bwd_dbc's blocks follow the batch and the card's SM count (two strips
    and all of n a block at B 128, L 512, chunk 128; half of n at B 4), and
    dE comes as its sums over the two halves of n at every shape: so a
    cloud's K8 and K9 outputs are bitwise the same in a batch of 4 as in one
    of 128 (dD, a sum over the batch, aside)."""
    from si_mamba_tpu_torch.ops.kernels import ssd as kssd

    args, dy, dh_fin = _sm90_operands(128, 512, 128, cuda)
    xbc, dth, S, D, d, chunk = args
    few = (xbc[:4], dth[:4], S[:4], D, d, chunk)
    y, h_in = kssd.ssd_xbc_fwd_states_bf16(*args)
    y4, h_in4 = kssd.ssd_xbc_fwd_states_bf16(*few)
    for seed in (None, dh_fin):
        extra = () if seed is None else (seed,)
        fn = kssd.ssd_xbc_bwd_bf16 if seed is None else kssd.ssd_xbc_bwd_seeded_bf16
        got = fn(xbc, dth, S, D, h_in, dy, *extra, d, chunk)
        got4 = fn(*few[:4], h_in4, dy[:4], *(e[:4] for e in extra), d, chunk)
        torch.cuda.synchronize()
        for name, a, w in zip(("dxbc", "ddt", "dS"), got[:3], got4[:3]):
            assert torch.equal(a[:4], w), (name, seed is not None)
    assert torch.equal(y[:4], y4) and torch.equal(h_in[:4], h_in4)


@pytest.mark.cuda
def test_ssd_sm90_body_refuses_what_it_does_not_serve(cuda):
    """The Hopper body's C entry points refuse a geometry outside their
    instantiation (d_state 256, chunk 96 and 320) and a scratch of another
    size by name, before launching anything; the wrappers never hand them
    such a call."""
    from si_mamba_tpu_torch.ops.kernels import ssd as kssd

    lib = kssd._sm90_library()
    b, l, h, d = 1, 256, 2, 256
    xbc = torch.zeros(b, l, d + 256, dtype=torch.bfloat16, device=cuda)
    dt = torch.zeros(b, h, l // 128, 128, device=cuda)
    D = torch.zeros(h, device=cuda)
    for n, chunk in ((256, 128), (128, 96), (128, 320)):
        with pytest.raises(RuntimeError, match="invalid argument"):
            kssd.run_sm90_fwd(lib, torch.zeros(b, 320, d + 2 * n, dtype=torch.bfloat16,
                                               device=cuda),
                              torch.zeros(b, h, 320 // chunk if 320 % chunk == 0 else 1, chunk,
                                          device=cuda), dt, D, d, chunk, True,
                              torch.cuda.current_stream().cuda_stream)
    h_in = torch.zeros(b, 2, h, 128, 128, device=cuda)
    scratch = torch.empty(kssd.sm90_bwd_scratch_floats(b, l, h, 128) - 4, device=cuda)
    dD = torch.empty(b, h, 2, 2, device=cuda)
    err = lib.ssd_sm90_bwd(xbc.data_ptr(), dt.data_ptr(), dt.data_ptr(), D.data_ptr(),
                           h_in.data_ptr(), xbc.data_ptr(), None, xbc.data_ptr(), dt.data_ptr(),
                           dt.data_ptr(), dD.data_ptr(), dD.numel(), scratch.data_ptr(),
                           scratch.numel(), b, l, h, d, 128, 128, 128, xbc.stride(0),
                           xbc.stride(1), xbc.stride(0), xbc.stride(1),
                           torch.cuda.current_stream().cuda_stream)
    assert lib.ssd_sm90_error_string(err).decode() == "invalid argument"


@pytest.mark.cuda
@pytest.mark.parametrize("b,l,h,chunk", [(2, 512, 3, 256), (2, 512, 3, 128), (1, 256, 2, 256)])
def test_split_bf16_kernels_match_plain(cuda, b, l, h, chunk):
    """The four bf16 K6 variants (the same y from each) and the bf16 K7 from 0
    and seeded (two runs bitwise equal) on x a column view of a wider bf16
    buffer (rows 4-byte aligned only) and B, C the halves of one bf16
    (b, l, 256) buffer, against their plain versions at bf16."""
    from si_mamba_tpu_torch.ops.kernels import ssd as kssd

    rng = np.random.default_rng(62)
    x, dth, S, Bm, Cm = _split_case(rng, b, l, h, chunk, cuda, layout="tp")
    bf = torch.bfloat16
    x = torch.cat([torch.zeros_like(x[..., :2]), x], dim=-1).to(bf)[..., 2:]
    bc = torch.cat([Bm, Cm], dim=-1).to(bf)
    Bm, Cm = bc[..., :128], bc[..., 128:]
    args = (x, dth, S, Bm, Cm, chunk)
    before, fp32 = _ssd_bf16_counts()
    y_lean = kssd.ssd_split_fwd_bf16(*args)
    y_s, h_in = kssd.ssd_split_fwd_states_bf16(*args)
    y_f, h_fin = kssd.ssd_split_fwd_hfin_bf16(*args)
    y_sf, h_in2, h_fin2 = kssd.ssd_split_fwd_states_hfin_bf16(*args)
    dy = _randn(rng, b, l, x.shape[-1], device=cuda).to(bf)
    dh_fin = _randn(rng, b, h, 128, 128, scale=0.1, device=cuda)
    runs = {seeded: [fn(*args[:5], h_in, dy, *((dh_fin,) if seeded else ()), chunk)
                     for _ in range(2)]
            for seeded, fn in ((False, kssd.ssd_split_bwd_bf16),
                               (True, kssd.ssd_split_bwd_seeded_bf16))}
    torch.cuda.synchronize()
    after, fp32_after = _ssd_bf16_counts()
    assert fp32_after == fp32
    assert {k: after[k] - before[k] for k in after if after[k] != before[k]} == {
        "ssd_split_fwd": 1, "ssd_split_fwd_states": 1, "ssd_split_fwd_hfin": 1,
        "ssd_split_fwd_states_hfin": 1, "ssd_split_bwd": 2, "ssd_split_bwd_seeded": 2}
    for y in (y_s, y_f, y_sf):
        torch.testing.assert_close(y, y_lean, rtol=0, atol=0)
    assert torch.equal(h_in, h_in2) and torch.equal(h_fin, h_fin2)
    y_ref, h_ref, hf_ref = kssd.ssd_split_fwd_ref(*args, emit_states=True, emit_hfin=True)
    for name, a, w in (("y", y_lean, y_ref), ("h_in", h_in, h_ref), ("h_fin", h_fin, hf_ref)):
        _hold_bf16(name, a, w)
    for seeded, (got, again) in runs.items():
        want = kssd.ssd_split_bwd_ref(*args[:5], h_in, dy, chunk,
                                      dh_fin=dh_fin if seeded else None)
        for name, a, a2, w in zip(("dx", "ddt", "dS", "dB", "dC"), got, again, want):
            torch.testing.assert_close(a, a2, rtol=0, atol=0)
            _hold_bf16(f"{name} (seeded {seeded})", a, w)


@pytest.mark.cuda
def test_ssd_bf16_kernels_refuse_rows_off_4_bytes(cuda):
    """A bf16 operand whose rows start 2 bytes off a 4-byte boundary has no
    copy the kernels can make (cp.async moves 4 or 16 bytes): the wrapper
    raises before launching; a mix of dtypes raises too."""
    from si_mamba_tpu_torch.ops.kernels import ssd as kssd

    rng = np.random.default_rng(63)
    xbc, dth, S, D, d = _ssd_case(rng, 1, 128, 1, 64, cuda)
    odd = torch.cat([xbc[..., :1], xbc], dim=-1).to(torch.bfloat16)[..., 1:]
    with pytest.raises(ValueError, match="4-byte aligned"):
        kssd.ssd_xbc_fwd(odd, dth, S, D, d, 64)
    good = xbc.to(torch.bfloat16).contiguous()
    _, h_in = kssd.ssd_xbc_fwd_states(good, dth, S, D, d, 64)
    with pytest.raises(TypeError, match="dy"):
        kssd.ssd_xbc_bwd(good, dth, S, D, h_in, torch.zeros(1, 128, d, device=cuda), d, 64)
    with pytest.raises(TypeError, match="D in torch.float32"):
        kssd.ssd_xbc_fwd(good, dth, S, D.to(torch.bfloat16), d, 64)


@pytest.mark.cuda
def test_bf16_ssd_model_kernel_path_matches_plain(cuda):
    """A small SSD classifier at the presets' settings (bf16, subspace,
    'ssd_fused', one head of 128, chunk 64, L 128) on the card: an eval
    forward launches only the bf16 K1 and the lean bf16 K8, a train step only
    the bf16 K1, K8 with states, K9 and K5 (K8 and K9 on the Hopper bf16
    body, its '_sm90' counts), and the eval logits are within
    3e-2 of the max of the plain route ('xla')."""
    cfg = dict(trans_dim=64, encoder_dims=64, depth=2, cls_dim=8, num_group=16,
               group_size=16, drop_path=0.0, cls_head_dropout=0.0, dtype="bfloat16",
               spectral_method="subspace", mixer="ssd", ssd_chunk=64, knn_graph=8)
    model = PointMamba(PointMambaConfig(**cfg, scan_impl="ssd_fused"),
                       generator=torch.Generator().manual_seed(3)).to(cuda)
    plain = PointMamba(PointMambaConfig(**cfg, scan_impl="xla")).to(cuda)
    plain.load_state_dict(model.state_dict())
    pts = _randn(np.random.default_rng(4), 4, 512, 3, device=cuda)
    before, fp32 = _bf16_counts(), _fp32_counts()
    ssd_before, ssd_fp32 = _ssd_bf16_counts()
    with torch.no_grad():
        logits = model.eval()(pts)
        want = plain.eval()(pts)
    torch.cuda.synchronize()
    assert [a - c for a, c in zip(_bf16_counts(), before)] == [2, 0, 0, 0, 0]
    ssd_after, _ = _ssd_bf16_counts()
    assert {k: ssd_after[k] - ssd_before[k] for k in ssd_after
            if ssd_after[k] != ssd_before[k]} == {"ssd_xbc_fwd_sm90": 2}
    assert logits.dtype == torch.bfloat16
    _close_to_max(logits.float(), want.float(), 3e-2)
    before, ssd_before = _bf16_counts(), _ssd_bf16_counts()[0]
    model.train()(pts).float().square().mean().backward()
    torch.cuda.synchronize()
    assert [a - c for a, c in zip(_bf16_counts(), before)] == [2, 2, 0, 0, 0]
    ssd_after, ssd_fp32_after = _ssd_bf16_counts()
    assert {k: ssd_after[k] - ssd_before[k] for k in ssd_after
            if ssd_after[k] != ssd_before[k]} == {"ssd_xbc_fwd_states_sm90": 2,
                                                   "ssd_xbc_bwd_sm90": 2}
    assert _fp32_counts() == fp32 and ssd_fp32_after == ssd_fp32
    assert all(p.grad is not None and p.grad.dtype == torch.float32 and
               torch.isfinite(p.grad).all() for p in model.parameters())


# ---------------------------------------------------------------------------
# the bf16 K10/K11 and K8/K9's carry entry points
# ---------------------------------------------------------------------------

def _fused_counts():
    from si_mamba_tpu_torch.ops.kernels import fused_mixer as kfm

    names = ("fused_mixer_fwd", "fused_mixer_fwd_states", "fused_mixer_bwd")
    return ({n: getattr(kfm, n + "_bf16").launches for n in names},
            {n: getattr(kfm, n).launches for n in names})


@pytest.mark.cuda
@pytest.mark.parametrize("b,l,d_model", [(4, 512, 384), (2, 100, 64), (3, 77, 384), (1, 512, 384)])
def test_bf16_fused_mixer_kernels_match_plain(cuda, b, l, d_model):
    """The bf16 K10 (lean and with states) and K11 on bf16 xz and g against
    their plain versions at bf16 (chip_smoke.py's tolerances: y and dxz within
    one bf16 ulp at a floor of 2e-2 of the max, both sides rounding one fp32
    value once; h_entries within 1e-5 of its max, the fp32 weight gradients
    within 1e-4, sums in another order); the lean y bitwise equal to the
    states variant's (the same segment count); two K11 runs bitwise equal;
    each launch counted on its bf16 wrapper and none on the fp32 ones."""
    from si_mamba_tpu_torch.ops.kernels import fused_mixer as kfm

    args = list(_fused_case(b, l, d_model, 40, cuda))
    args[0] = args[0].to(torch.bfloat16)
    g = _randn(np.random.default_rng(41), b, l, 2 * d_model, device=cuda).to(torch.bfloat16)
    before, fp32 = _fused_counts()
    y_lean = kfm.fused_mixer_fwd_bf16(*args)
    y, h_entries = kfm.fused_mixer_fwd_states(*args)
    got = kfm.fused_mixer_bwd_bf16(*args, h_entries, g)
    again = kfm.fused_mixer_bwd(*args, h_entries, g)
    torch.cuda.synchronize()
    after, fp32_after = _fused_counts()
    assert fp32_after == fp32
    assert {k: after[k] - before[k] for k in after} == {
        "fused_mixer_fwd": 1, "fused_mixer_fwd_states": 1, "fused_mixer_bwd": 2}
    assert y.dtype == torch.bfloat16 and h_entries.dtype == torch.float32
    torch.testing.assert_close(y, y_lean, rtol=0, atol=0)
    y_ref, h_ref = kfm.fused_mixer_fwd_ref(*args, chunk=kfm.CHUNK, emit_states=True)
    assert _bf16_ulps(y, y_ref, floor=2e-2) <= 1, _bf16_ulps(y, y_ref, floor=2e-2)
    _close_to_max(h_entries, h_ref, 1e-5)
    want = kfm.fused_mixer_bwd_ref(*args, h_entries, g, chunk=kfm.CHUNK)
    names = ("dxz", "dconv_wt", "dconv_b", "dx_proj", "ddt_proj", "ddtb", "dat", "dd")
    for name, a, w, a2 in zip(names, got, want, again):
        assert a.shape == w.shape and a.dtype == w.dtype, name
        assert torch.equal(a, a2), name
        if name == "dxz":
            assert a.dtype == torch.bfloat16 and _bf16_ulps(a, w, floor=2e-2) <= 1, name
        else:
            _close_to_max(a, w, 1e-4)


@pytest.mark.cuda
def test_bf16_fused_mixer_kernels_take_only_fp32_weights(cuda):
    """bf16 xz with a weight in any other dtype than fp32, or with an fp32 g,
    raises before launching: the bf16 kernels read fp32 weights."""
    from si_mamba_tpu_torch.ops.kernels import fused_mixer as kfm

    args = list(_fused_case(1, 32, 64, 42, cuda))
    args[0] = args[0].to(torch.bfloat16)
    before = _fused_counts()
    for i, name in ((1, "conv_wt"), (3, "x_proj"), (7, "d")):
        bad = list(args)
        bad[i] = args[i].to(torch.bfloat16)
        with pytest.raises(TypeError, match=name):
            kfm.fused_mixer_fwd(*bad)
    _, h_entries = kfm.fused_mixer_fwd_ref(*args, chunk=kfm.CHUNK, emit_states=True)
    with pytest.raises(TypeError, match="g in torch.bfloat16"):
        kfm.fused_mixer_bwd(*args, h_entries, torch.zeros(1, 32, 128, device=cuda))
    assert _fused_counts() == before


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,l,h,chunk", [(2, 512, 2, 256), (1, 192, 3, 64), (1, 64, 1, 64)])
def test_ssd_carry_kernels_match_plain(cuda, b, l, h, chunk, dtype):
    """K8 with h_fin (lean and with states) and the seeded K9 against their
    plain versions, at fp32 (y and h_fin within 1e-5 of their max, every
    gradient within 1e-4, as the K8/K9 tests here) and at bf16 (the bf16
    kernels' tolerances: a bf16 output within 2 ulps at a floor of 2e-2, the
    fp32 ones within 1e-3): y bitwise equal to K8's without the carry, the
    two h_fin variants bitwise equal, two seeded K9 runs bitwise equal, each
    launch counted on its own wrapper's count of the variant that ran it (at
    bf16 the Hopper bf16 body, '_sm90')."""
    from si_mamba_tpu_torch.ops.kernels import ssd as kssd

    bf16 = dtype == "bfloat16"
    sfx = "_bf16" if bf16 else ""
    rng = np.random.default_rng(70)
    xbc, dth, S, D, d = _ssd_case(rng, b, l, h, chunk, cuda)
    dy = _randn(rng, b, l, d + 2, device=cuda)[..., 2:]
    dh_fin = _randn(rng, b, h, 128, 128, scale=0.1, device=cuda)
    if bf16:
        xbc, dy = xbc.to(torch.bfloat16), dy.to(torch.bfloat16)
    names = ("ssd_xbc_fwd_hfin", "ssd_xbc_fwd_states_hfin", "ssd_xbc_bwd_seeded")
    variant = kssd.kernel_variant(chunk, 128, 128, xbc.dtype)

    def launches(n):
        if variant:
            return kssd.VARIANT_LAUNCHES[kssd._variant_name(n + sfx, variant)].launches
        return getattr(kssd, n + sfx).launches

    assert variant == ("_sm90" if bf16 else "")
    before = {n: launches(n) for n in names}
    args = (xbc, dth, S, D, d, chunk)
    y_plain = kssd.ssd_xbc_fwd(*args)
    y_lean, hf_lean = getattr(kssd, "ssd_xbc_fwd_hfin" + sfx)(*args)
    y, h_in, h_fin = getattr(kssd, "ssd_xbc_fwd_states_hfin" + sfx)(*args)
    seeded = getattr(kssd, "ssd_xbc_bwd_seeded" + sfx)
    got = seeded(xbc, dth, S, D, h_in, dy, dh_fin, d, chunk)
    again = seeded(xbc, dth, S, D, h_in, dy, dh_fin, d, chunk)
    torch.cuda.synchronize()
    assert {n: launches(n) - before[n] for n in names} == {
        "ssd_xbc_fwd_hfin": 1, "ssd_xbc_fwd_states_hfin": 1, "ssd_xbc_bwd_seeded": 2}
    for a, w in ((y_lean, y_plain), (y, y_plain), (hf_lean, h_fin), *zip(got, again)):
        torch.testing.assert_close(a, w, rtol=0, atol=0)
    y_ref, h_ref, hf_ref = kssd.ssd_xbc_fwd_ref(*args, emit_states=True, emit_hfin=True)
    want = kssd.ssd_xbc_bwd_ref(xbc, dth, S, D, h_in, dy, d, chunk, dh_fin=dh_fin)
    assert h_fin.shape == (b, h, 128, 128) and h_fin.dtype == torch.float32
    if bf16:
        for name, a, w in (("y", y, y_ref), ("h_in", h_in, h_ref), ("h_fin", h_fin, hf_ref),
                           *zip(("dxbc", "ddt", "dS", "dD"), got, want)):
            _hold_bf16(name, a, w)
    else:
        for a, w, tol in ((y, y_ref, 1e-5), (h_in, h_ref, 1e-5), (h_fin, hf_ref, 1e-5),
                          *((a, w, 1e-4) for a, w in zip(got, want))):
            _close_to_max(a, w, tol)


# ---------------------------------------------------------------------------
# the part-segmentation path: the kernels at its shapes, and its 3-NN
# ---------------------------------------------------------------------------
# cfgs/part_segmentation*.yaml: batch 16, the HLT canvas of L = 2 * 128 = 256
# tokens, d_inner 768 (Mamba-1, xz 1536 wide) or 1024 with the SSD view (in_proj
# 1798 wide, 6 heads, chunk 128: two chunks)
SEG_B, SEG_L = 16, 256


@pytest.mark.cuda
@pytest.mark.parametrize("d,row,off", [(768, 1536, 0), (1024, 1798, 768)],
                         ids=["mamba-view", "ssd-view"])
def test_conv_kernels_at_the_seg_shapes(cuda, d, row, off):
    """K1 and K5 at the seg path's operands, at their plain versions'
    tolerances (rtol 1e-5, atol 1e-6; 1e-5 of each gradient's max)."""
    rng = np.random.default_rng(80)
    x, weight, bias, g = _conv_bwd_case(rng, SEG_B, SEG_L, d, row, off, 0, cuda)
    before = (kconv.causal_conv1d_silu.launches, kconv.causal_conv1d_silu_bwd.launches)
    y = kconv.causal_conv1d_silu(x, weight, bias)
    got = kconv.causal_conv1d_silu_bwd(x, weight, bias, g)
    torch.cuda.synchronize()
    assert (kconv.causal_conv1d_silu.launches, kconv.causal_conv1d_silu_bwd.launches) == (
        before[0] + 1, before[1] + 1)
    torch.testing.assert_close(y, kconv.causal_conv1d_ref(x, weight, bias), rtol=1e-5, atol=1e-6)
    for a, want in zip(got, kconv.causal_conv1d_silu_bwd_ref(x, weight, bias, g)):
        _close_to_max(a, want, 1e-5)


@pytest.mark.cuda
def test_scan_kernels_at_the_seg_shape(cuda):
    """K2, K3 and K4 at batch 16, L = 256, d_inner 768."""
    _scan_kernels_against_plain(_scan_case(np.random.default_rng(81), SEG_B, SEG_L, 768, cuda))


@pytest.mark.cuda
def test_ssd_kernels_at_the_seg_shape(cuda):
    """The lean K8, K8 with states and K9 at batch 16, L = 256, 6 heads,
    chunk 128 (two chunks), within 1e-5 (forward) and 1e-4 (gradients) of
    their plain versions' max."""
    from si_mamba_tpu_torch.ops.kernels import ssd as kssd

    rng = np.random.default_rng(82)
    xbc, dth, S, D, d = _ssd_case(rng, SEG_B, SEG_L, 6, 128, cuda)
    dy = _randn(rng, SEG_B, SEG_L, d + 3, device=cuda)[..., 3:]
    y_lean = kssd.ssd_xbc_fwd(xbc, dth, S, D, d, 128)
    y, h_in = kssd.ssd_xbc_fwd_states(xbc, dth, S, D, d, 128)
    got = kssd.ssd_xbc_bwd(xbc, dth, S, D, h_in, dy, d, 128)
    torch.cuda.synchronize()
    torch.testing.assert_close(y, y_lean, rtol=0, atol=0)
    y_ref, h_ref = kssd.ssd_xbc_fwd_ref(xbc, dth, S, D, d, 128, emit_states=True)
    assert h_in.shape == (SEG_B, 2, 6, 128, 128)
    _close_to_max(y, y_ref, 1e-5)
    _close_to_max(h_in, h_ref, 1e-5)
    for a, w in zip(got, kssd.ssd_xbc_bwd_ref(xbc, dth, S, D, h_in, dy, d, 128)):
        _close_to_max(a, w, 1e-4)


@pytest.mark.cuda
def test_three_nn_breaks_ties_to_the_lower_index_on_cuda(cuda):
    """The seg model's 3-NN on the card picks what it picks on the CPU on an
    HLT-like canvas (chunks twice, zero slots) whose copies tie bitwise: the
    lower index, as ``jax.lax.top_k``. The interpolation is held within 1e-6
    against the same weights computed on the CPU from the card's distances:
    cuBLAS rounds other entries than the CPU's GEMM, and at a point that
    coincides with a centre (distance about 0) the weight 1 / (d + 1e-8)
    follows that rounding."""
    from si_mamba_tpu_torch.models.segmentation import feature_propagation_interp, three_nn

    rng = np.random.default_rng(83)
    base = _randn(rng, 4, 64, 3)
    centres = torch.cat([base, base.flip(1), base[:, :16], torch.zeros(4, 96, 3)], dim=1)
    pts = torch.cat([base, torch.zeros(4, 8, 3), _randn(rng, 4, 512, 3)], dim=1)
    feats = _randn(rng, 4, centres.shape[1], 32)
    _, want = three_nn(pts, centres)
    d_gpu, got = three_nn(pts.to(cuda), centres.to(cuda))
    assert torch.equal(got.cpu(), want)
    assert int((d_gpu[..., 0] == d_gpu[..., 1]).sum()) >= 4 * 72  # the ties are there
    w = 1.0 / (torch.clamp_min(d_gpu.cpu(), 0.0) + 1e-8)
    w = w / w.sum(-1, keepdim=True)
    picked = torch.gather(feats, 1, want.reshape(4, -1, 1).expand(-1, -1, 32)).reshape(4, -1, 3, 32)
    torch.testing.assert_close(
        feature_propagation_interp(pts.to(cuda), centres.to(cuda), feats.to(cuda)).cpu(),
        (picked * w[..., None]).sum(2), rtol=0, atol=1e-6)


@pytest.mark.cuda
def test_small_seg_ssd_train_gradients_match_xla(cuda):
    """A small HLT seg model on the SSD mixer in training, kernels (K1, K8
    with states, K9, K5, once a block) against 'xla', one tie-break and head
    keep mask on both: the losses within 2e-4, every gradient but those of
    the biases whose every effect a BatchNorm removes within 1e-3 of its
    leaf's largest."""
    from si_mamba_tpu_torch.models.segmentation import PartSegConfig, PartSegModel, nll_loss
    from si_mamba_tpu_torch.ops.kernels import ssd as kssd

    cfg = dict(trans_dim=128, encoder_dims=128, depth=2, fetch_idx=(0, 1), num_group=64,
               group_size=16, k_top_eigenvectors=3, drop_path=0.0, mixer="ssd", ssd_chunk=64)
    model = PartSegModel(PartSegConfig(**cfg, scan_impl="ssd_fused")).to(cuda)
    plain = PartSegModel(PartSegConfig(**cfg, scan_impl="xla")).to(cuda)
    plain.load_state_dict(model.state_dict(), strict=True)
    rng = np.random.default_rng(85)
    pts = _randn(rng, 3, 512, 3, device=cuda)
    onehot = torch.eye(16, device=cuda)[[1, 5, 12]]
    seg = torch.from_numpy(rng.integers(0, 50, (3, 512))).to(cuda)
    draws = dict(order_noise=torch.from_numpy(rng.random((3, 64), dtype=np.float32)).to(cuda),
                 head_mask=torch.from_numpy(rng.random((3, 512, 512)) < 0.5).to(cuda))
    k9 = kssd.ssd_xbc_bwd.launches
    losses = [nll_loss(m.train()(pts, onehot, **draws), seg) for m in (model, plain)]
    for loss in losses:
        loss.backward()
    assert kssd.ssd_xbc_bwd.launches == k9 + 2
    torch.testing.assert_close(losses[0], losses[1], rtol=2e-4, atol=0)
    bn_fed = {"encoder.first_conv.0.bias", "encoder.first_conv.3.bias",
              "encoder.second_conv.0.bias", "norm.bias", "prop_fc1.bias", "prop_fc2.bias",
              "convs1.bias", "convs2.bias"}
    for (name, p), q in zip(model.named_parameters(), plain.parameters()):
        if name not in bn_fed:
            _close_to_max(p.grad, q.grad, 1e-3)


@pytest.mark.cuda
def test_small_seg_model_kernel_path_matches_plain(cuda):
    """A small HLT seg model's eval log-probs, kernels against 'seq', with one
    injected tie-break on both: atol 1e-3 max|logp|, rtol 2e-3."""
    from si_mamba_tpu_torch.models.segmentation import PartSegConfig, PartSegModel

    cfg = dict(trans_dim=64, encoder_dims=64, depth=4, fetch_idx=(1, 2, 3), num_group=32,
               group_size=16, k_top_eigenvectors=3, drop_path=0.0)
    model = PartSegModel(PartSegConfig(**cfg)).to(cuda).eval()
    plain = PartSegModel(PartSegConfig(**cfg, scan_impl="seq")).to(cuda).eval()
    plain.load_state_dict(model.state_dict(), strict=True)
    rng = np.random.default_rng(84)
    pts = _randn(rng, 3, 512, 3, device=cuda)
    onehot = torch.eye(16, device=cuda)[[1, 5, 12]]
    noise = torch.rand(3, 32, generator=torch.Generator().manual_seed(0)).to(cuda)
    before = kconv.causal_conv1d_silu.launches
    with torch.inference_mode():
        got = model(pts, onehot, order_noise=noise)
        want = plain(pts, onehot, order_noise=noise)
    assert kconv.causal_conv1d_silu.launches == before + 4
    torch.testing.assert_close(got, want, rtol=2e-3, atol=1e-3 * want.abs().max().item())


# ---------------------------------------------------------------------------
# the kernels at the shapes of their any-shape variants
# ---------------------------------------------------------------------------

def _ulp_or_rel(got, want, tol_fp32, tol_bf16):
    _close_to_max(got.float(), want.float(), tol_bf16 if got.dtype == torch.bfloat16
                  else tol_fp32)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("W", [1, 2, 3, 5, 9])
def test_conv_any_width_holds_and_repeats(cuda, W, dtype):
    """K1/K5 at widths other than 4 (the any-width variants) on a column view
    of xz: y, dx, dw, db against the plain versions (fp32 1e-5 of max, bf16
    outputs one ulp, 2e-2 of max), the backward bitwise repeatable."""
    rng = np.random.default_rng(60 + W)
    xz = _randn(rng, 3, 70, 192, device=cuda).to(dtype)
    x, g = xz[..., :96], _randn(rng, 3, 70, 96, device=cuda).to(dtype)
    w, b = _randn(rng, 96, W, scale=0.4, device=cuda), _randn(rng, 96, scale=0.1, device=cuda)
    name = "_bf16" if dtype == torch.bfloat16 else ""
    f0 = kconv.ANY_LAUNCHES["causal_conv1d_silu_any" + name].launches
    b0 = kconv.ANY_LAUNCHES["causal_conv1d_silu_bwd_any" + name].launches
    _ulp_or_rel(kconv.causal_conv1d_silu_fwd(x, w, b), kconv.causal_conv1d_ref(x, w, b),
                1e-5, 2e-2)
    got = kconv.causal_conv1d_silu_bwd(x, w, b, g)
    again = kconv.causal_conv1d_silu_bwd(x, w, b, g)
    for a, r, c in zip(got, kconv.causal_conv1d_silu_bwd_ref(x, w, b, g), again):
        _ulp_or_rel(a, r, 1e-5, 2e-2)
        assert torch.equal(a, c)
    assert kconv.ANY_LAUNCHES["causal_conv1d_silu_any" + name].launches == f0 + 1
    assert kconv.ANY_LAUNCHES["causal_conv1d_silu_bwd_any" + name].launches == b0 + 2


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n", [1, 8, 12, 32, 64, 300])
def test_scan_any_state_holds_and_repeats(cuda, n, dtype):
    """K2, K3 and K4 at d_state other than 16 (the any-state variants; at 300
    their arrays in the global workspace): y, h_entries and every gradient
    against the plain versions, K4 bitwise repeatable; K3's y equal to K2's."""
    rng = np.random.default_rng(70 + n)
    b, l, d = 2, 75, 96
    act = lambda *s, scale=1.0: _randn(rng, *s, scale=scale, device=cuda).to(dtype)  # noqa: E731
    u, delta, z, g = act(b, l, d), act(b, l, d, scale=0.5), act(b, l, d), act(b, l, d)
    x_dbl = act(b, l, 2 * n + 3)
    Bm, Cm = x_dbl[..., 3:3 + n], x_dbl[..., 3 + n:]
    A = -(_randn(rng, d, n, device=cuda).abs() + 0.1)
    D, db = _randn(rng, d, device=cuda), _randn(rng, d, scale=0.1, device=cuda)
    y = kscan.selective_scan_fwd(u, delta, A, Bm, Cm, D, z, db)
    _ulp_or_rel(y, kscan.selective_scan_ref(u, delta, A, Bm, Cm, D=D, z=z, delta_bias=db),
                1e-5, 2e-2)
    y3, he = kscan.selective_scan_fwd_residuals(u, delta, A, Bm, Cm, D, z, db)
    assert torch.equal(y3, y)
    _close_to_max(he, kscan.selective_scan_fwd_residuals_ref(u, delta, A, Bm, Cm, D, z, db)[1],
                  1e-5)
    got = kscan.selective_scan_bwd(u, delta, A, Bm, Cm, D, z, db, g, he)
    again = kscan.selective_scan_bwd(u, delta, A, Bm, Cm, D, z, db, g, he)
    want = kscan.selective_scan_bwd_ref(u, delta, A, Bm, Cm, D, z, db, g, he)
    for a, r, c in zip(got, want, again):
        _ulp_or_rel(a, r, 1e-4, 3e-2)
        assert torch.equal(a, c)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d_model,d_state,d_conv,dt_rank", [
    (576, 16, 4, 36), (1280, 16, 4, 80), (128, 8, 3, 8), (128, 32, 2, 8)])
def test_fused_mixer_any_shape_holds_and_repeats(cuda, d_model, d_state, d_conv, dt_rank,
                                                 dtype):
    """K10/K11 at d_inner 1152 and 2560, d_state 8 and 32, conv widths 3 and
    2 (the global-memory variants): y, h_entries and the eight gradients
    against the plain versions, K11 bitwise repeatable."""
    from si_mamba_tpu_torch.models.layers import MambaMixer
    from si_mamba_tpu_torch.ops.kernels import fused_mixer as kfm

    mixer = MambaMixer(d_model, d_state=d_state, d_conv=d_conv, dt_rank=dt_rank)
    mixer.reset_parameters(torch.Generator().manual_seed(d_model + d_state))
    p = {k: v.detach().to(cuda) for k, v in mixer.params().items()}
    rng = np.random.default_rng(d_model)
    x = _randn(rng, 2, 40, d_model, device=cuda)
    xz = (x @ p["in_proj_w"]).to(dtype)
    args = kfm.kernel_inputs(xz, p["conv_w"], p["conv_b"], p["x_proj_w"], p["dt_proj_w"],
                             p["dt_proj_b"], -torch.exp(p["A_log"]), p["D"], dt_rank=dt_rank,
                             d_state=d_state)
    y, h = kfm.fused_mixer_fwd_states(*args)
    y_ref, h_ref = kfm.fused_mixer_fwd_ref(*args, chunk=kfm.CHUNK, emit_states=True)
    _ulp_or_rel(y, y_ref, 1e-5, 2e-2)
    _close_to_max(h, h_ref, 1e-5)
    g = _randn(rng, 2, 40, xz.shape[-1] // 2, device=cuda).to(dtype)
    got, again = kfm.fused_mixer_bwd(*args, h, g), kfm.fused_mixer_bwd(*args, h, g)
    for a, r, c in zip(got, kfm.fused_mixer_bwd_ref(*args, h, g, chunk=kfm.CHUNK), again):
        _ulp_or_rel(a, r, 1e-4, 2e-2)
        assert torch.equal(a, c)


def _ssd_any_case(rng, b, l, h, chunk, device, dtype, n=128, p=128):
    """xbc in ``dtype`` (contiguous), dt and S (b, h, nc, chunk), D (h,)."""
    xbc = (_randn(rng, b, l, h * p + 2 * n, scale=0.5, device=device)).to(dtype)
    dth = torch.tensor(rng.uniform(0.0, 0.05, (b, h, l // chunk, chunk)).astype(np.float32),
                       device=device)
    A = -torch.tensor(rng.uniform(0.1, 1.0, h).astype(np.float32), device=device)
    S = torch.cumsum(dth * A[None, :, None, None], -1).contiguous()
    return xbc, dth, S, _randn(rng, h, device=device)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("chunk,l", [(8, 64), (32, 128), (96, 192), (512, 512), (1024, 1024)])
def test_ssd_kernels_at_every_chunk_hold(cuda, chunk, l, dtype):
    """Every K8/K9 and K6/K7 entry point at chunks that are no multiple of
    the 64-row strip (laid out in strips) and longer than 256 (the per-chunk
    arrays sized at launch), against the plain versions at that chunk; each
    launch on its variant's count."""
    from si_mamba_tpu_torch.ops.kernels import ssd as kssd

    rng = np.random.default_rng(chunk)
    h, n = 2, 128
    d = h * 128
    xbc, dth, S, D = _ssd_any_case(rng, 2, l, h, chunk, cuda, dtype)
    dy = _randn(rng, 2, l, d, device=cuda).to(dtype)
    dh_fin = _randn(rng, 2, h, n, 128, device=cuda)
    bf = dtype == torch.bfloat16
    fwd_tol, st_tol, grad_tol = (2e-2, 1e-3, 3e-2) if bf else (1e-5, 1e-5, 1e-4)
    variant = kssd.chunk_variant(chunk)
    assert variant in ("_strip", "_long")
    count = lambda name: kssd.VARIANT_LAUNCHES[  # noqa: E731
        kssd._variant_name(name + ("_bf16" if bf else ""), variant)].launches
    c0 = {k: count(k) for k in ("ssd_xbc_fwd_states_hfin", "ssd_xbc_bwd_seeded",
                                "ssd_split_fwd_states_hfin", "ssd_split_bwd_seeded")}
    y, h_in, h_fin = kssd.ssd_xbc_fwd_states_hfin(xbc, dth, S, D, d, chunk)
    ry, rh, rf = kssd.ssd_xbc_fwd_ref(xbc, dth, S, D, d, chunk, emit_states=True,
                                      emit_hfin=True)
    _ulp_or_rel(y, ry, fwd_tol, fwd_tol)
    _close_to_max(h_in, rh, st_tol)
    _close_to_max(h_fin, rf, st_tol)
    assert torch.equal(kssd.ssd_xbc_fwd(xbc, dth, S, D, d, chunk), y)
    got = kssd.ssd_xbc_bwd_seeded(xbc, dth, S, D, h_in, dy, dh_fin, d, chunk)
    want = kssd.ssd_xbc_bwd_ref(xbc, dth, S, D, h_in, dy, d, chunk, dh_fin=dh_fin)
    for a, r in zip(got, want):
        _ulp_or_rel(a, r, grad_tol, grad_tol)
    x, Bm, Cm = xbc[..., :d], xbc[..., d:d + n], xbc[..., d + n:]
    ys, hs, fs = kssd.ssd_split_fwd_states_hfin(x, dth, S, Bm, Cm, chunk)
    rys, _, rfs = kssd.ssd_split_fwd_ref(x, dth, S, Bm, Cm, chunk, emit_states=True,
                                         emit_hfin=True)
    _ulp_or_rel(ys, rys, fwd_tol, fwd_tol)
    _close_to_max(fs, rfs, st_tol)
    got = kssd.ssd_split_bwd_seeded(x, dth, S, Bm, Cm, hs, dy, dh_fin, chunk)
    want = kssd.ssd_split_bwd_ref(x, dth, S, Bm, Cm, hs, dy, chunk, dh_fin=dh_fin)
    for a, r in zip(got, want):
        _ulp_or_rel(a, r, grad_tol, grad_tol)
    assert {k: count(k) - v for k, v in c0.items()} == dict.fromkeys(c0, 1)


@pytest.mark.cuda
def test_ssd_states_zero_the_whole_first_entry_state_at_chunk_192(cuda):
    """K8 with states writes h_in[0] = 0 in full at chunk 192 (three strips,
    which do not divide the 128 x 128 state evenly), whatever the allocator
    hands it."""
    from si_mamba_tpu_torch.ops.kernels import ssd as kssd

    junk = torch.full((1 << 26,), float("nan"), device=cuda)
    del junk
    xbc, dth, S, D = _ssd_any_case(np.random.default_rng(192), 2, 384, 2, 192, cuda,
                                   torch.float32)
    _, h_in = kssd.ssd_xbc_fwd_states(xbc, dth, S, D, 256, 192)
    assert bool((h_in[:, 0] == 0).all())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("chunk", [32, 256, 512])
@pytest.mark.parametrize("n,p,h", [(256, 256, 1), (256, 128, 2), (128, 256, 1), (384, 384, 1)])
def test_ssd_kernels_at_wide_states_hold_and_repeat(cuda, n, p, h, chunk, dtype):
    """Every K8/K9 and K6/K7 entry point at d_state and head_dim that are
    multiples of 128 other than 128 (the wide instantiation), at a chunk of
    each variant, against the plain versions (fp32: 1e-5 of max forward,
    1e-4 backward; bf16: 2e-2 and 3e-2 of max, the fp32 states 1e-3), each
    launch on its '_wide' variant's count; every backward run twice is
    bitwise equal."""
    from si_mamba_tpu_torch.ops.kernels import ssd as kssd

    rng = np.random.default_rng(n + p + chunk)
    l, d = 512, h * p
    xbc, dth, S, D = _ssd_any_case(rng, 2, l, h, chunk, cuda, dtype, n=n, p=p)
    dy = _randn(rng, 2, l, d, device=cuda).to(dtype)
    dh_fin = _randn(rng, 2, h, n, p, device=cuda)
    bf = dtype == torch.bfloat16
    fwd_tol, st_tol, grad_tol = (2e-2, 1e-3, 3e-2) if bf else (1e-5, 1e-5, 1e-4)
    variant = kssd.kernel_variant(chunk, n, p)
    assert variant.endswith("_wide")
    count = lambda name: kssd.VARIANT_LAUNCHES[  # noqa: E731
        kssd._variant_name(name + ("_bf16" if bf else ""), variant)].launches
    names = ("ssd_xbc_fwd", "ssd_xbc_fwd_states_hfin", "ssd_xbc_bwd", "ssd_xbc_bwd_seeded",
             "ssd_split_fwd_hfin", "ssd_split_fwd_states", "ssd_split_bwd",
             "ssd_split_bwd_seeded")
    c0 = {k: count(k) for k in names}
    y, h_in, h_fin = kssd.ssd_xbc_fwd_states_hfin(xbc, dth, S, D, d, chunk)
    ry, rh, rf = kssd.ssd_xbc_fwd_ref(xbc, dth, S, D, d, chunk, emit_states=True,
                                      emit_hfin=True)
    _ulp_or_rel(y, ry, fwd_tol, fwd_tol)
    _close_to_max(h_in, rh, st_tol)
    _close_to_max(h_fin, rf, st_tol)
    assert torch.equal(kssd.ssd_xbc_fwd(xbc, dth, S, D, d, chunk), y)
    for seed in (None, dh_fin):
        want = kssd.ssd_xbc_bwd_ref(xbc, dth, S, D, h_in, dy, d, chunk, dh_fin=seed)
        runs = [kssd.ssd_xbc_bwd(xbc, dth, S, D, h_in, dy, d, chunk) if seed is None else
                kssd.ssd_xbc_bwd_seeded(xbc, dth, S, D, h_in, dy, seed, d, chunk)
                for _ in range(2)]
        for a, b, r in zip(*runs, want):
            _ulp_or_rel(a, r, grad_tol, grad_tol)
            assert torch.equal(a, b)
    x, Bm, Cm = xbc[..., :d], xbc[..., d:d + n], xbc[..., d + n:]
    ys, hs = kssd.ssd_split_fwd_states(x, dth, S, Bm, Cm, chunk)
    yf, fs = kssd.ssd_split_fwd_hfin(x, dth, S, Bm, Cm, chunk)
    rys, rhs, rfs = kssd.ssd_split_fwd_ref(x, dth, S, Bm, Cm, chunk, emit_states=True,
                                           emit_hfin=True)
    _ulp_or_rel(ys, rys, fwd_tol, fwd_tol)
    _close_to_max(hs, rhs, st_tol)
    _close_to_max(fs, rfs, st_tol)
    assert torch.equal(yf, ys)
    for seed in (None, dh_fin):
        want = kssd.ssd_split_bwd_ref(x, dth, S, Bm, Cm, hs, dy, chunk, dh_fin=seed)
        runs = [kssd.ssd_split_bwd(x, dth, S, Bm, Cm, hs, dy, chunk) if seed is None else
                kssd.ssd_split_bwd_seeded(x, dth, S, Bm, Cm, hs, dy, seed, chunk)
                for _ in range(2)]
        for a, b, r in zip(*runs, want):
            _ulp_or_rel(a, r, grad_tol, grad_tol)
            assert torch.equal(a, b)
    torch.cuda.synchronize()
    launched = {k: count(k) - v for k, v in c0.items()}
    assert launched == dict(ssd_xbc_fwd=1, ssd_xbc_fwd_states_hfin=1, ssd_xbc_bwd=2,
                            ssd_xbc_bwd_seeded=2, ssd_split_fwd_hfin=1, ssd_split_fwd_states=1,
                            ssd_split_bwd=2, ssd_split_bwd_seeded=2)
