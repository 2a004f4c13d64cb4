"""The plain Jamba block (AI21-Jamba2-3B's layer equations), its
next-token loss, gradients and first AdamW steps.

Plain PyTorch; it imports nothing of the port (the AdamW step and the
leaf order are :mod:`bench.reference.train`'s). The param tree is the
port's layout, which ``bench/models/jamba.py`` lists: one period of
``attn_layer_period`` slots, stacked, with attention in slot
``attn_layer_offset`` and Mamba-1 in the others; a SwiGLU MLP in every
slot; each mixer and MLP behind its RMSNorm; the tied embedding as the
head. As HF's ``JambaForCausalLM`` (``modeling_jamba.py``) computes it:

* RMSNorm: ``x * rsqrt(mean(x^2) + eps) * w``;
* attention: ``n_heads`` query heads over ``n_kv_heads`` KV heads, no
  positional encoding, causal softmax over ``q k / sqrt(head_dim)``;
* Mamba-1 (``JambaMambaMixer.slow_forward``): ``in_proj`` to x and z, a
  depthwise causal conv of width ``mamba_d_conv`` with its bias, SiLU,
  ``x_proj`` to dt (``mamba_dt_rank``), B and C (``mamba_d_state``) each
  through its RMSNorm (``dt_layernorm``, ``b_layernorm``,
  ``c_layernorm``), ``softplus(dt_proj(dt) + dt_bias)``, the scan
  written as its recurrence ``s = exp(dt A) s + dt B x``, ``y = C s +
  D x``, ``y * silu(z)``, ``out_proj``; ``A = -exp(A_log)``;
* SwiGLU: ``down(silu(gate(x)) * up(x))``;
* the loss: the mean cross-entropy of each position's next token.

Float32 throughout, with TF32 off. The one departure: each product's
inputs (matrix products, the attention's two, the conv's taps, and the
scan's x, B and C) are rounded to bfloat16, where the program computes
or holds them in bfloat16, so that the limits can be tight
(``bf16=False`` leaves them in float32). The matrix products of the
weights (:class:`BF16Product`) round the gradient that comes into their
backward to bfloat16 as well, as the program's bfloat16 products take
it, and run on the tensor cores with TF32 allowed: a bfloat16 value is
exact in TF32, so each of their products is exact and summed in float32,
as TF32 off would give, in about a tenth of the time.
To fit at the published widths after the window, the layers, the
attention's query blocks and the loss's position blocks are recomputed
in the backward, and the scan's time chunks keep only their inputs (their
backward is the adjoint recurrence, also written as a loop over the
steps); all rows go through at once.

``fault`` plants one of the controls: ``"bf16_scan"`` rounds the state
to bfloat16 after each step, ``"no_inner_norms"`` leaves the three
inner RMSNorms out, ``"chunk_reset"`` restarts the state from zero at
each of the scan's time chunks.
"""
from __future__ import annotations

import contextlib
import math
from typing import List, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from bench.reference import train as RTR

SCAN_CHUNK = 256    # the recurrence's steps a recomputed chunk
QUERY_BLOCK = 512   # attention's queries a recomputed block
LOSS_BLOCK = 512    # the loss's positions a recomputed block
FAULTS = (None, "bf16_scan", "no_inner_norms", "chunk_reset")


@contextlib.contextmanager
def ieee(tf32: bool = False):
    """Float32 products in IEEE float32 (TF32 off) inside, or with TF32
    allowed (``tf32``)."""
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).float()


class BF16Product(torch.autograd.Function):
    """``a @ b`` (2-d) of operands rounded to bfloat16, in float32; its
    backward rounds the incoming gradient to bfloat16, and the two
    gradients it gives, as the program's bfloat16 product does. Every
    operand is then exact in TF32, so the products run with TF32 allowed
    and lose nothing to it."""

    @staticmethod
    def forward(ctx, a, b):
        a, b = a.to(torch.bfloat16), b.to(torch.bfloat16)
        ctx.save_for_backward(a, b)
        with ieee(tf32=True):
            return a.float() @ b.float()

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        a, b = (t.float() for t in ctx.saved_tensors)
        g = _bf16(g)
        with ieee(tf32=True):
            return _bf16(g @ b.T), _bf16(a.T @ g)


class Plain:
    """The block's forward for one configuration (``bench/models/jamba``'s
    ``dims``), products rounded to bfloat16 or not, with a fault or
    none."""

    def __init__(self, dims: dict, bf16: bool = True,
                 fault: Optional[str] = None):
        if fault not in FAULTS:
            raise ValueError(f"fault {fault!r} not in {FAULTS}")
        self.d, self.bf16, self.fault = dims, bf16, fault

    def r(self, x: torch.Tensor) -> torch.Tensor:
        """A product's input as the program gives it."""
        return x.to(torch.bfloat16).float() if self.bf16 else x

    def mm(self, x, w):
        """``x @ w`` over x's last dim: a product of the weights."""
        if not self.bf16:
            return x @ w
        y = BF16Product.apply(x.reshape(-1, x.shape[-1]), w)
        return y.view(*x.shape[:-1], w.shape[-1])

    def norm(self, x, w):
        return x * torch.rsqrt(x.square().mean(-1, keepdim=True)
                               + self.d["eps"]) * w

    # ------------------------------------------------------------ attention
    def attention(self, p, x):
        B, S, _ = x.shape
        nq, nkv, hd = self.d["n_heads"], self.d["n_kv_heads"], \
            self.d["head_dim"]
        q, k, v = (self.mm(x, p[n].flatten(1)).view(B, S, -1, hd)
                   for n in ("wq", "wk", "wv"))
        k = k.repeat_interleave(nq // nkv, dim=2)
        v = v.repeat_interleave(nq // nkv, dim=2)
        outs = [checkpoint(self._attend, q[:, i:i + QUERY_BLOCK], k, v, i,
                           use_reentrant=False)
                for i in range(0, S, QUERY_BLOCK)]
        o = torch.cat(outs, dim=1)
        return self.mm(o.flatten(2), p["wo"].flatten(0, 1))

    def _attend(self, q, k, v, start):
        hd = q.shape[-1]
        logits = torch.einsum("bqhk,bshk->bhqs", self.r(q), self.r(k)) / \
            math.sqrt(hd)
        qpos = start + torch.arange(q.shape[1], device=q.device)
        kpos = torch.arange(k.shape[1], device=q.device)
        logits = logits.masked_fill(kpos[None, :] > qpos[:, None],
                                    float("-inf"))
        w = torch.softmax(logits, dim=-1)
        return torch.einsum("bhqs,bshk->bqhk", self.r(w), self.r(v))

    # ---------------------------------------------------------------- mamba
    def mamba(self, p, x):
        L = x.shape[1]
        xz = self.mm(x, p["in_proj"])
        xi, z = xz.chunk(2, dim=-1)
        kw = p["conv_w"].shape[0]
        xp = F.pad(self.r(xi), (0, 0, kw - 1, 0))
        w = self.r(p["conv_w"])
        xc = sum(xp[:, i:i + L] * w[i] for i in range(kw)) + p["conv_b"]
        xc = F.silu(xc)
        R, N = self.d["dt_rank"], self.d["d_state"]
        dt_in, Bm, Cm = torch.split(self.mm(xc, p["x_proj"]), [R, N, N],
                                    dim=-1)
        if self.fault != "no_inner_norms":
            dt_in = self.norm(dt_in, p["dt_norm"])
            Bm = self.norm(Bm, p["b_norm"])
            Cm = self.norm(Cm, p["c_norm"])
        dt = F.softplus(self.mm(dt_in, p["dt_proj"]) + p["dt_bias"])
        A = -torch.exp(p["A_log"])
        xr = self.r(xc)
        y = self.scan(xr, dt, A, self.r(Bm), self.r(Cm)) + p["D"] * xr
        return self.mm(y * F.silu(z), p["out_proj"])

    def scan(self, x, dt, A, Bm, Cm):
        return scan(x, dt, A, Bm, Cm, self.fault)

    # ---------------------------------------------------------------- model
    def slot(self, h, sp, attn: bool):
        x = self.norm(h, sp["ln1"])
        h = h + (self.attention(sp["mix"], x) if attn
                 else self.mamba(sp["mix"], x))
        x = self.norm(h, sp["ln2"])
        f = sp["ffn"]
        g = F.silu(self.mm(x, f["w_gate"])) * self.mm(x, f["w_up"])
        return h + self.mm(g, f["w_down"])

    def hidden(self, params, tokens):
        """The final norm's output (rows, S, d_model)."""
        h = params["embed"]["table"][tokens]
        per = params["periods"]
        for k in range(per["ln1"].shape[0]):
            i_m = 0
            for s in range(self.d["period"]):
                attn = s == self.d["attn_index"]
                mix = {n: w[k] for n, w in per["attn"].items()} if attn \
                    else {n: w[k, i_m] for n, w in per["mamba"].items()}
                sp = {"ln1": per["ln1"][k, s], "ln2": per["ln2"][k, s],
                      "mix": mix,
                      "ffn": {n: w[k, s] for n, w in per["ffn"].items()}}
                h = checkpoint(self.slot, h, sp, attn, use_reentrant=False)
                i_m += not attn
        return self.norm(h, params["final_norm"])

    def logits(self, params, tokens):
        """(rows, S, vocab) logits, whole (small sizes only)."""
        return self._logits(self.hidden(params, tokens),
                            params["embed"]["table"])

    def _logits(self, h, table):
        return self.mm(h, table.T)

    def loss(self, params, tokens, labels):
        """The mean next-token cross-entropy over every position."""
        h = self.hidden(params, tokens)
        table = params["embed"]["table"]
        total = torch.zeros((), device=h.device)
        for i in range(0, h.shape[1], LOSS_BLOCK):
            total = total + checkpoint(
                self._nll, h[:, i:i + LOSS_BLOCK], table,
                labels[:, i:i + LOSS_BLOCK], use_reentrant=False)
        return total / labels.numel()

    def _nll(self, h, table, labels):
        logits = self._logits(h, table)
        return F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                               labels.reshape(-1), reduction="sum")


def scan(x, dt, A, Bm, Cm, fault: Optional[str] = None):
    """y_t = sum_n C_tn s_tn of the recurrence from s = 0, a time chunk
    at a time (:class:`Recurrence`); x, dt (B, S, di), A (di, N), Bm, Cm
    (B, S, N). ``fault`` as :class:`Plain`'s."""
    s = torch.zeros(x.shape[0], x.shape[2], A.shape[1], device=x.device)
    ys = []
    for t0 in range(0, x.shape[1], SCAN_CHUNK):
        sl = slice(t0, t0 + SCAN_CHUNK)
        if fault == "chunk_reset":
            s = torch.zeros_like(s)
        y, s = Recurrence.apply(x[:, sl], dt[:, sl], A, Bm[:, sl],
                                Cm[:, sl], s, fault == "bf16_scan")
        ys.append(y)
    return torch.cat(ys, dim=1)


def _walk(a, b, s, bf16_state: bool):
    """The states of ``s_t = a_t s_{t-1} + b_t`` from ``s``, a step at a
    time; a, b (B, c, di, N) -> (B, c, di, N), each step written in
    place."""
    out = torch.empty_like(a)
    for t in range(a.shape[1]):
        s = torch.addcmul(b[:, t], a[:, t], s, out=out[:, t])
        if bf16_state:
            s.copy_(s.to(torch.bfloat16))
    return out


class Recurrence(torch.autograd.Function):
    """One time chunk of the selective scan, written as its recurrence:
    ``s_t = exp(dt_t A) s_{t-1} + dt_t B_t x_t``, ``y_t = sum_n C_tn
    s_tn``, from the state ``s0``; returns (y, the chunk's last state).
    Its backward walks the adjoint recurrence ``g_t = dy_t C_t +
    exp(dt_{t+1} A) g_{t+1}`` back through the chunk (the states
    recomputed), so no step is an autograd node: the chunk keeps only its
    inputs. The sums over N, and over rows and steps, are products
    (``einsum``), so no (B, c, di, N) product is kept for a sum alone.
    With ``bf16_state`` each state is rounded to bfloat16 (a control; its
    backward takes the rounding as the identity)."""

    @staticmethod
    def forward(ctx, x, dt, A, Bm, Cm, s0, bf16_state):
        ctx.save_for_backward(x, dt, A, Bm, Cm, s0)
        ctx.bf16_state = bf16_state
        a, b = Recurrence._factors(x, dt, A, Bm)
        states = _walk(a, b, s0, bf16_state)
        return (torch.einsum("btdn,btn->btd", states, Cm),
                states[:, -1].clone())

    @staticmethod
    def _factors(x, dt, A, Bm):
        return ((dt[..., None] * A).exp_(),                   # B, c, di, N
                (dt * x)[..., None] * Bm[:, :, None, :])

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dy, ds_last):
        x, dt, A, Bm, Cm, s0 = ctx.saved_tensors
        a, b = Recurrence._factors(x, dt, A, Bm)
        states = _walk(a, b, s0, ctx.bf16_state)
        del b
        g = torch.einsum("btd,btn->btdn", dy, Cm)          # dy_t C_t, then
        g[:, -1] += ds_last
        for t in range(x.shape[1] - 2, -1, -1):            # the adjoint
            g[:, t].addcmul_(a[:, t + 1], g[:, t + 1])
        # exp(dt_t A) s_{t-1}, times g: the sums over dt and A take it
        h = torch.empty_like(a)
        torch.mul(a[:, 0], s0, out=h[:, 0])
        torch.mul(a[:, 1:], states[:, :-1], out=h[:, 1:])
        ds0 = a[:, 0] * g[:, 0]
        del a
        h.mul_(g)
        gB = torch.einsum("btdn,btn->btd", g, Bm)
        return (gB * dt,                                           # x
                gB * x + torch.einsum("btdn,dn->btd", h, A),       # dt
                torch.einsum("btd,btdn->dn", dt, h),               # A
                torch.einsum("btdn,btd->btn", g, dt * x),          # B
                torch.einsum("btd,btdn->btn", dy, states),         # C
                ds0,                                               # s0
                None)


def loss_and_grads(plain: Plain, params, tokens, labels):
    """(loss, gradients in ``RTR.leaves`` order; zeros for a leaf the loss
    does not reach, as the program gives)."""
    flat = [x.detach().clone().requires_grad_(True)
            for _, x in RTR.leaves(params)]
    with ieee():
        loss = plain.loss(RTR.rebuild(params, flat), tokens, labels)
        grads = torch.autograd.grad(loss, flat, materialize_grads=True)
    return loss.detach(), list(grads)


def run_steps(params, batches, opt: RTR.AdamW, dims: dict, device,
              bf16: bool = True, fault: Optional[str] = None):
    """The first ``len(batches)`` steps from ``params`` (any device; the
    reference runs on ``device``) on ``batches`` of ``(tokens, labels)``.
    Returns the losses, the clipped first gradients and the params
    after the last step, both on ``device`` in ``RTR.leaves`` order."""
    plain = Plain(dims, bf16, fault)
    flat = [x.detach().to(device, torch.float32).clone()
            for _, x in RTR.leaves(params)]
    ndims = [x.ndim for x in flat]
    m = [torch.zeros_like(x) for x in flat]
    v = [torch.zeros_like(x) for x in flat]
    losses: List[float] = []
    first = None
    for step, (tokens, labels) in enumerate(batches, start=1):
        loss, grads = loss_and_grads(plain, RTR.rebuild(params, flat),
                                     tokens.to(device), labels.to(device))
        flat, m, v, clipped = RTR.adamw_step(flat, grads, m, v, step, opt,
                                             ndims)
        del grads
        losses.append(float(loss))
        if first is None:
            first = clipped
        del clipped
    return losses, first, flat
