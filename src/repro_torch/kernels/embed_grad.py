"""The conv1d encoder's embedding lookup with the PAD mask, as one op whose
backward is a hand-written CUDA kernel.

* :func:`masked_gather` (:class:`MaskedGather`) is ``table[ids] * (ids !=
  0)``: the two PyTorch ops the conv1d encoder ran for its lookup, so its
  forward keeps their bits. Only a caller that multiplies the lookup by
  the PAD mask may use it: the LM's lookup, where id 0 is a token, may
  not.
* :func:`embed_grad` is its backward, the table's gradient: for each id
  other than 0, the sum of the output gradient's rows at that id's
  positions, summed in float32 (float64 for float64) and stored in the
  gradient's dtype. Row 0 and the rows of ids that do not occur are
  zero.

For CUDA tensors :func:`embed_grad` sorts the ids (``torch.sort``,
stable) and launches ``csrc/embed_grad.cu``, whose header says what bounds
it on an H100 and how its design follows; nothing it does makes the host
wait for the card. For tensors on the CPU it runs its plain version,
:func:`embed_grad_ref`. There is no fallback from one to the other.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

LIB = "embed_grad"
CHUNK = 64  # sorted positions a block sums: kChunk in csrc/embed_grad.cu

_ENTRY = {torch.float32: "embed_grad_f32", torch.bfloat16: "embed_grad_bf16",
          torch.float64: "embed_grad_f64"}
_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGS = (_P, _P, _P, _I, _I, _I, _P, _P, ctypes.c_size_t, _P)
_ERRORS = {-1: (RuntimeError, "embed_grad kernel launch failed (-1): "
                "workspace smaller than the plan's")}


class MaskedGather(torch.autograd.Function):
    """``table[ids] * (ids != 0)``, with :func:`embed_grad` as the table's
    gradient; ``ids`` gets none."""

    @staticmethod
    def forward(ctx, table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
        ctx.save_for_backward(ids)
        ctx.vocab = table.shape[0]
        return table[ids] * (ids != 0).to(table.dtype)[..., None]

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, grad: torch.Tensor):
        ids, = ctx.saved_tensors
        return embed_grad(grad.contiguous(), ids, ctx.vocab), None


def masked_gather(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """(V, E) table, ids of any shape -> ``table[ids]`` with PAD's rows
    zeroed, in the table's dtype."""
    return MaskedGather.apply(table, ids)


def _acc_dtype(dtype: torch.dtype) -> torch.dtype:
    """The sums' dtype: float64 for float64 rows, else float32."""
    return torch.float64 if dtype == torch.float64 else torch.float32


def embed_grad_ref(grad: torch.Tensor, ids: torch.Tensor,
                   vocab: int) -> torch.Tensor:
    """The plain version of :func:`embed_grad`: ``index_add_`` of the
    non-PAD positions' rows into zeros of the sums' dtype, in position
    order, cast to the gradient's dtype."""
    acc = _acc_dtype(grad.dtype)
    keep = (ids != 0).reshape(-1)
    rows = grad.reshape(-1, grad.shape[-1])[keep].to(acc)
    out = torch.zeros((vocab, grad.shape[-1]), dtype=acc, device=grad.device)
    return out.index_add_(0, ids.reshape(-1)[keep], rows).to(grad.dtype)


def _check(grad: torch.Tensor, ids: torch.Tensor, vocab: int) -> None:
    if grad.dtype not in _ENTRY:
        raise ValueError(f"grad must be float32, bfloat16 or float64, "
                         f"got {grad.dtype}")
    if ids.dtype not in (torch.int32, torch.int64):
        raise ValueError(f"ids must be int32 or int64, got {ids.dtype}")
    if grad.dim() != ids.dim() + 1 or grad.shape[:-1] != ids.shape:
        raise ValueError(f"grad must be ids' shape plus a width, got grad "
                         f"{tuple(grad.shape)} and ids {tuple(ids.shape)}")
    if grad.device != ids.device:
        raise ValueError(f"grad and ids must be on one device, got "
                         f"{grad.device} and {ids.device}")
    if not (grad.is_contiguous() and ids.is_contiguous()):
        raise ValueError("grad and ids must be contiguous")
    if not 1 <= vocab < 2 ** 31 or ids.numel() >= 2 ** 31:
        raise ValueError(f"vocab must lie in [1, 2**31) and ids hold fewer "
                         f"than 2**31 positions, got vocab {vocab} and "
                         f"{ids.numel()} positions")


def embed_grad(grad: torch.Tensor, ids: torch.Tensor,
               vocab: int) -> torch.Tensor:
    """The (vocab, E) table gradient of :func:`masked_gather`.

    grad: (..., E) float32, bfloat16 or float64, the output's gradient;
    ids: the lookup's int32 or int64 ids, grad's shape without its
    width. The sums run in float32 (float64 for float64) in an order fixed
    by the positions, so two launches give the same bits; the result has
    grad's dtype. Ids lie in [0,
    vocab), as the forward's lookup requires: the kernel adds any other
    to no row, the plain version raises. Each launch of the kernel adds
    one to ``embed_grad.launches``."""
    _check(grad, ids, vocab)
    if grad.device.type == "cpu":
        return embed_grad_ref(grad, ids, vocab)
    if grad.device.type != "cuda":
        raise ValueError(f"no kernel for device {grad.device}")
    return _launch(grad, ids, vocab)


def _launch(grad: torch.Tensor, ids: torch.Tensor,
            vocab: int) -> torch.Tensor:
    """Sort the ids and launch the kernel on checked CUDA tensors (no
    checks here: call :func:`embed_grad`). Counts the launch."""
    width, n = grad.shape[-1], ids.numel()
    out = torch.zeros((vocab, width), dtype=grad.dtype, device=grad.device)
    if n == 0 or width == 0:
        return out
    keys, perm = torch.sort(ids.reshape(-1).to(torch.int32), stable=True)
    # two slots of partial sums a chunk (the kernel refuses fewer bytes)
    work = torch.empty(-(-n // CHUNK) * 2 * width,
                       dtype=_acc_dtype(grad.dtype), device=grad.device)
    _build.launch(
        embed_grad, LIB, _build.bind(_build.load(LIB), _ENTRY[grad.dtype],
                                     _ARGS), grad.device,
        (grad.data_ptr(), keys.data_ptr(), perm.data_ptr(), n, width,
         vocab, out.data_ptr(), work.data_ptr(), work.nbytes), _ERRORS)
    return out


embed_grad.launches = 0
