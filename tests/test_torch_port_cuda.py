"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs a CUDA device and the CUDA toolkit (the kernels have no
CPU mode) and skips without one. The file imports only the port, so on a
machine with a GPU and no JAX it runs with the suite's conftest left out:

    python -m pytest --noconftest -q tests/test_torch_port_cuda.py
"""

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
