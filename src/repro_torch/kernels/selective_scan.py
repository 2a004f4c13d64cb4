"""The Mamba-1 selective scan as one op whose forward and backward are
hand-written CUDA kernels (``csrc/selective_scan.cu``, whose header says
what bounds them on an H100 and how their design follows).

:func:`selective_scan` (:class:`SelectiveScan`) takes float32 CUDA
tensors x, dt (dt after its softplus) of (rows, L, channels), A
(channels, N), B, C (rows, L, N) and D (channels), and gives y of x's
shape: for each row, channel and state, from s = 0,
``s_t = exp(dt_t A) s_{t-1} + dt_t B_t x_t`` and
``y_t = sum_n C_tn s_tn + D x_t``. The state and every sum are float32.
Its backward gives dx, ddt, dA, dB, dC and dD with no float atomics, so
two runs give the same bits. N is 8 or 16.

The plain version is ``models.mamba.chunked_scan`` plus ``D * x``, which
``models.mamba.mamba_apply`` runs where this does not apply (the CPU,
DTensors). Each launch of the forward entry and each of the backward
entry adds one to ``selective_scan.launches``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

LIB = "selective_scan"
CHUNK = 16       # steps between saved states: kT in csrc/selective_scan.cu
THREADS = 128    # a block's threads: kThreads there
PER = 4          # states a thread holds: kPer there
STATES = (8, 16)

_P, _I = ctypes.c_void_p, ctypes.c_int
_FWD = (_P,) * 8 + (_I,) * 4 + (_P,)
_BWD = (_P,) * 15 + (ctypes.c_size_t,) + (_I,) * 4 + (_P,)
_ERRORS = {-1: (ValueError, "selective_scan: N must be 8 or 16 and the "
                "shape non-empty with at most 65,535 rows, got {}"),
           -2: (RuntimeError, "selective_scan: workspace smaller than the "
                "plan's")}


def n_chunks(L: int) -> int:
    return -(-L // CHUNK)


def n_blocks(D: int, N: int) -> int:
    """Channel blocks a row: THREADS / (N / PER) channels each."""
    ch = THREADS * PER // N
    return -(-D // ch)


def workspace_floats(rows: int, L: int, D: int, N: int) -> int:
    """The backward's workspace: the blocks' dB and dC partials, then the
    rows' dA and dD."""
    return rows * L * n_blocks(D, N) * 2 * N + rows * D * N + rows * D


class SelectiveScan(torch.autograd.Function):
    """y of the selective scan; saves its inputs and the state before
    every chunk of CHUNK steps for the backward."""

    @staticmethod
    def forward(ctx, x, dt, A, B, C, D):
        y, states = _forward(x, dt, A, B, C, D)
        ctx.save_for_backward(x, dt, A, B, C, D, states)
        return y

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dy):
        return _backward(*ctx.saved_tensors, dy.contiguous())


def _check(x, dt, A, B, C, D) -> None:
    ts = {"x": x, "dt": dt, "A": A, "B": B, "C": C, "D": D}
    for name, t in ts.items():
        if t.dtype != torch.float32:
            raise ValueError(f"{name} must be float32, got {t.dtype}")
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
    if x.dim() != 3 or dt.shape != x.shape:
        raise ValueError(f"x and dt must be one (rows, L, channels) shape, "
                         f"got {tuple(x.shape)} and {tuple(dt.shape)}")
    rows, L, ch = x.shape
    N = A.shape[-1]
    if A.shape != (ch, N) or D.shape != (ch,) or \
            B.shape != (rows, L, N) or C.shape != (rows, L, N):
        raise ValueError(f"A must be (channels, N), D (channels,), B and C "
                         f"(rows, L, N); got x {tuple(x.shape)}, A "
                         f"{tuple(A.shape)}, B {tuple(B.shape)}, C "
                         f"{tuple(C.shape)}, D {tuple(D.shape)}")
    if N not in STATES:
        raise ValueError(f"N must be one of {STATES}, got {N}")


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """Contiguous, at a 16-byte address (the kernels read float4s)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def selective_scan(x, dt, A, B, C, D) -> torch.Tensor:
    """y (rows, L, channels) of the selective scan on float32 CUDA
    tensors; differentiable in every input."""
    _check(x, dt, A, B, C, D)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    return SelectiveScan.apply(*(_aligned(t) for t in (x, dt, A, B, C, D)))


def _lib():
    return _build.load(LIB)


def _forward(x, dt, A, B, C, D):
    rows, L, ch = x.shape
    N = A.shape[1]
    y = torch.empty_like(x)
    states = torch.empty((rows, n_chunks(L), ch, N), dtype=torch.float32,
                         device=x.device)
    _build.launch(
        selective_scan, LIB,
        _build.bind(_lib(), "selective_scan_fwd", _FWD), x.device,
        (x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(),
         C.data_ptr(), D.data_ptr(), y.data_ptr(), states.data_ptr(),
         rows, L, ch, N), _ERRORS, ((rows, L, ch, N),))
    return y, states


def _backward(x, dt, A, B, C, D, states, dy):
    rows, L, ch = x.shape
    N = A.shape[1]
    dx, ddt = torch.empty_like(x), torch.empty_like(x)
    dA, dD = torch.empty_like(A), torch.empty_like(D)
    dB, dC = torch.empty_like(B), torch.empty_like(C)
    work = torch.empty(workspace_floats(rows, L, ch, N), dtype=torch.float32,
                       device=x.device)
    _build.launch(
        selective_scan, LIB,
        _build.bind(_lib(), "selective_scan_bwd", _BWD), x.device,
        (x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(),
         C.data_ptr(), D.data_ptr(), states.data_ptr(), dy.data_ptr(),
         dx.data_ptr(), ddt.data_ptr(), dA.data_ptr(), dB.data_ptr(),
         dC.data_ptr(), dD.data_ptr(), work.data_ptr(), work.nbytes,
         rows, L, ch, N), _ERRORS, ((rows, L, ch, N),))
    return dx, ddt, dA, dB, dC, dD


selective_scan.launches = 0
