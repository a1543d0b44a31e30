"""The port's CUDA kernels against their plain PyTorch versions, on the card.

The tests marked ``cuda`` need a CUDA device and the CUDA toolkit (the
kernels have no CPU mode) and skip without one; the gradient checks of the
autograd Functions run their plain path in float64 on any host. The file
imports only the port, so on a machine with a GPU and no JAX it runs with
the suite's conftest left out:

    python -m pytest --noconftest -q tests/test_torch_port_cuda.py
"""

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
@pytest.mark.parametrize("l,d", [(37, 24), (512, 200), (64, 130), (65, 768)])
def test_conv_kernel_matches_plain(cuda, l, d):
    rng = np.random.default_rng(0)
    xz = _randn(rng, 2, l, 2 * d, device=cuda)
    weight, bias = _randn(rng, d, 4, scale=0.5, device=cuda), _randn(rng, d, scale=0.1, device=cuda)
    x = xz[..., :d]  # a column slice, as in the mixer
    before = kconv.causal_conv1d_silu.launches
    got = kconv.causal_conv1d_silu(x, weight, bias)
    torch.cuda.synchronize()
    assert kconv.causal_conv1d_silu.launches == before + 1
    torch.testing.assert_close(got, kconv.causal_conv1d_ref(x, weight, bias),
                               rtol=1e-5, atol=1e-6)


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
    for w in (3, 5):
        with pytest.raises(ValueError, match="width 4"):
            kconv.causal_conv1d_silu(x, _randn(rng, 16, w, device=cuda),
                                     _randn(rng, 16, device=cuda))
    with pytest.raises(ValueError, match="one CUDA device"):
        kconv.causal_conv1d_silu(x, _randn(rng, 16, 4), _randn(rng, 16))
    u = _randn(rng, 1, 8, 16, device=cuda)
    BC = _randn(rng, 1, 8, 5, device=cuda)
    with pytest.raises(ValueError, match="d_state 16"):
        kscan.selective_scan_fwd(u, u, _randn(rng, 16, 5, device=cuda), BC, BC,
                                 _randn(rng, 16, device=cuda), u, _randn(rng, 16, device=cuda))


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
    with pytest.raises(ValueError, match="multiple of 64"):
        kssd.ssd_xbc_fwd(xbc, dth.reshape(1, 1, 4, 32).contiguous(),
                         S.reshape(1, 1, 4, 32).contiguous(), D, d, 32)
    small, dth2, S2, D2, d2 = _ssd_case(rng, 1, 128, 1, 64, cuda, n=64)
    with pytest.raises(ValueError, match="d_state 128"):
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
    n_scratch = kssd.bwd_scratch_floats(1, 128, 1, 64)
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
    with pytest.raises(ValueError, match="multiple of 64"):
        kssd.ssd_split_fwd(x, dth.reshape(1, 1, 4, 32).contiguous(),
                           S.reshape(1, 1, 4, 32).contiguous(), Bm, Cm, 32)
    xs, dth2, S2, Bs, Cs = _split_case(rng, 1, 128, 1, 64, cuda, n=64)
    with pytest.raises(ValueError, match="d_state 128"):
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
    """dt_rank 34 at d_state 16 (R + 2N = 66 > 64): every wrapper raises and
    nothing is launched."""
    from si_mamba_tpu_torch.ops.kernels import fused_mixer as kfm

    args = _fused_case(1, 32, 64, 55, cuda, dt_rank=34)
    counts = lambda: (kfm.fused_mixer_fwd.launches,  # noqa: E731
                      kfm.fused_mixer_fwd_states.launches, kfm.fused_mixer_bwd.launches)
    before = counts()
    h = torch.zeros(1, 2, 16, 128, device=cuda)
    g = torch.zeros(1, 32, 128, device=cuda)
    for call in (lambda: kfm.fused_mixer_fwd(*args), lambda: kfm.fused_mixer_fwd_states(*args),
                 lambda: kfm.fused_mixer_bwd(*args, h, g)):
        with pytest.raises(NotImplementedError, match="dt_rank \\+ 2 d_state up to 64"):
            call()
    assert counts() == before


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
    32) that the kernels are not built for: on CUDA it raises, never the
    plain path; so does float64 at the kernel wrapper."""
    from si_mamba_tpu_torch.models.layers import MambaMixer
    from si_mamba_tpu_torch.ops.kernels import fused_mixer as kfm

    mixer = MambaMixer(64, d_state=8, scan_impl="fused").to(cuda)
    x = _randn(np.random.default_rng(35), 1, 16, 64, device=cuda)
    before = kfm.fused_mixer_fwd.launches
    with pytest.raises(NotImplementedError, match="K10/K11"):
        with torch.no_grad():
            mixer(x)
    assert kfm.fused_mixer_fwd.launches == before
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
