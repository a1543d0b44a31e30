"""The C interface of ``csrc/mamba_any.cu``: the Mamba-1 kernels at the
shapes the tuned ones are not built for (the conv at any width, the scan at
any d_state, the whole mixer at any d_inner that is a multiple of 128 and any
d_state up to 32). The wrappers of ``causal_conv``, ``selective_scan`` and
``fused_mixer`` pick these variants by shape and launch them through
:func:`library`; the source describes their designs. Nothing here runs at
import time."""

from __future__ import annotations

import ctypes
import functools

from si_mamba_tpu_torch.ops.kernels.build import load_library

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_PP = ctypes.POINTER(ctypes.c_void_p)
_SIGNATURES = {
    "conv_any_fwd": ([_P] * 4 + [_I] * 4 + [_LL] * 2 + [_P], _I),
    "conv_any_bwd": ([_P] * 9 + [_LL] + [_I] * 4 + [_LL] * 4 + [_P], _I),
    "scan_any_fwd": ([_PP, _P, _P] + [_I] * 4 + [ctypes.POINTER(_LL), _P], _I),
    "scan_any_bwd": ([_PP, _PP, _LL] + [_I] * 4 + [ctypes.POINTER(_LL), _P], _I),
    "mixer_any_fwd": ([_PP, _P, _P, _PP] + [_I] * 6 + [_P], _I),
    "mixer_any_bwd": ([_PP, _PP, _PP] + [_I] * 6 + [_P], _I),
}


@functools.cache
def library() -> ctypes.CDLL:
    """The built ``mamba_any`` library with its argument lists declared; each
    entry point has an ``_f32`` and a ``_bf16`` variant."""
    lib = load_library("mamba_any")
    for name, (args, res) in _SIGNATURES.items():
        for suffix in ("_f32", "_bf16"):
            fn = getattr(lib, name + suffix)
            fn.argtypes, fn.restype = args, res
    lib.conv_any_part_floats.argtypes = [_I] * 4
    lib.conv_any_part_floats.restype = _LL
    lib.scan_any_state_floats.argtypes = [_I] * 3
    lib.scan_any_state_floats.restype = _LL
    lib.scan_any_workspace_floats.argtypes = [_I] * 4
    lib.scan_any_workspace_floats.restype = _LL
    for name in ("scan_any_block_channels", "scan_any_chunk_len", "scan_any_max_shared_state"):
        getattr(lib, name).restype = _I
    lib.mamba_any_error_string.argtypes = [_I]
    lib.mamba_any_error_string.restype = ctypes.c_char_p
    return lib


def entry(name: str, bf16: bool):
    """The ``_f32`` or ``_bf16`` variant of entry point ``name``."""
    return getattr(library(), name + ("_bf16" if bf16 else "_f32"))


def check(err: int, what: str) -> None:
    """Raise for a non-zero cudaError_t code."""
    if err != 0:
        msg = library().mamba_any_error_string(err).decode()
        raise RuntimeError(f"{what} kernel launch failed: {msg} ({err})")


def pointers(tensors) -> ctypes.Array:
    """A C array of the tensors' device addresses (None for a null pointer)."""
    return (ctypes.c_void_p * len(tensors))(
        *(None if t is None else t.data_ptr() for t in tensors))


def longs(values) -> ctypes.Array:
    return (ctypes.c_longlong * len(values))(*values)
