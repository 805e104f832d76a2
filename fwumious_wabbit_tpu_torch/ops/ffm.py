"""FFM field-pair interactions — the counterpart of
fwumious_wabbit_tpu/ops/pallas/ffm.py.

:func:`ffm_triangle` computes, per example,

    C[t,f,:]    = Σ_{n: field(n)=f} v_n · emb[n, t·k:(t+1)·k]
    inter[t,f]  = ½⟨C[t,f,:], C[f,t,:]⟩ − [t=f]·½Σ_{n∈t} v_n²‖emb[n, t·k:(t+1)·k]‖²
    out[tri(i,j)] = inter[i,j] · (2 if j < i else 1)   (row-major lower triangle)

On a CUDA tensor it launches the hand-written kernel in
``csrc/ffm_triangle.cu`` (built on first use) or raises; there is no
fallback. On a CPU tensor it runs :func:`ffm_triangle_reference`, the plain
PyTorch version, which mirrors the JAX model's unfused path
(fwumious_wabbit_tpu/models/model.py:418-443).

:func:`ffm_triangle_bwd` is its gradient with respect to ``emb`` (the JAX
package takes it from ``jax.vjp``): a second hand-written kernel in the same
source on a CUDA tensor, torch autograd through the plain version on a CPU
tensor. :class:`FfmTriangle` joins the two as a ``torch.autograd.Function``.
"""

from __future__ import annotations

import threading

import torch

from .kernels import build

LAUNCHES = 0  # kernel launches made by ffm_triangle (CUDA tensors only)
BWD_LAUNCHES = 0  # kernel launches made by ffm_triangle_bwd (CUDA tensors only)
_count_lock = threading.Lock()

# dynamic shared memory a block may use on Hopper (227 KB)
SMEM_LIMIT_BYTES = 232448


def triangle_indices(F: int):
    """(i, j, scale) of the row-major lower triangle, off-diagonal ×2."""
    ti, tj, scale = [], [], []
    for i in range(F):
        for j in range(i + 1):
            ti.append(i)
            tj.append(j)
            scale.append(2.0 if j < i else 1.0)
    return ti, tj, scale


def ffm_triangle_reference(emb: torch.Tensor, vals: torch.Tensor,
                           fields: torch.Tensor, F: int, k: int) -> torch.Tensor:
    """Plain PyTorch version: ``[B, N, F·k]`` slabs → ``[B, F(F+1)/2]``.
    A field outside ``[0, F)`` (−1 padding) maps to the zero one-hot row."""
    B, N, _ = emb.shape
    e = emb.reshape(B, N, F, k)  # e[b,n,t,:] = w_n→t
    onehot = (fields.long().unsqueeze(-1)
              == torch.arange(F, device=emb.device)).to(emb.dtype)  # [B,N,F]
    weighted = e * vals[:, :, None, None]
    C = torch.einsum("bnf,bntk->btfk", onehot, weighted)
    inter = 0.5 * torch.einsum("btfk,bftk->btf", C, C)
    own = torch.einsum("bntk,bnt->bnk", e, onehot)  # w_n→field(n)
    self_term = 0.5 * (own * own).sum(-1) * vals * vals  # [B,N]
    diag = torch.einsum("bn,bnf->bf", self_term, onehot)  # [B,F]
    inter = inter - torch.diag_embed(diag)
    ti, tj, scale = triangle_indices(F)
    return inter[:, ti, tj] * torch.tensor(scale, dtype=emb.dtype,
                                           device=emb.device)


def shared_memory_bytes(F: int, k: int, backward: bool = False) -> int:
    """Dynamic shared memory a block of the forward (C and F self terms) or
    of the backward (C and the F×F upstream gradient) needs; raises
    ValueError above the card's per-block limit."""
    smem = (F * F * k + (F * F if backward else F)) * 4
    if smem > SMEM_LIMIT_BYTES:
        raise ValueError(
            f"F={F}, k={k} needs {smem} bytes of shared memory per example in "
            f"the FFM {'backward' if backward else 'forward'} kernel; the "
            f"limit is {SMEM_LIMIT_BYTES} bytes (227 KB)")
    return smem


def _check(emb, vals, fields, F, k, backward: bool) -> None:
    if emb.dim() != 3 or emb.shape[2] != F * k:
        raise ValueError(f"emb must be [B, N, F*k={F * k}], got {tuple(emb.shape)}")
    B, N = emb.shape[:2]
    if tuple(vals.shape) != (B, N) or tuple(fields.shape) != (B, N):
        raise ValueError(f"vals and fields must be [B, N]={B, N}, got "
                         f"{tuple(vals.shape)} and {tuple(fields.shape)}")
    if emb.dtype != torch.float32 or vals.dtype != torch.float32:
        raise TypeError("emb and vals must be float32")
    if fields.dtype != torch.int32:
        raise TypeError("fields must be int32")
    if not (emb.device == vals.device == fields.device):
        raise ValueError("emb, vals and fields must be on one device")
    if not (emb.is_contiguous() and vals.is_contiguous()
            and fields.is_contiguous()):
        raise ValueError("emb, vals and fields must be contiguous")
    shared_memory_bytes(F, k, backward)
    if emb.device.index != torch.cuda.current_device():
        raise ValueError(f"the FFM kernels launch on the current device "
                         f"cuda:{torch.cuda.current_device()}, not {emb.device}")


def ffm_triangle(emb: torch.Tensor, vals: torch.Tensor, fields: torch.Tensor,
                 F: int, k: int) -> torch.Tensor:
    """``[B, N, F·k]`` f32 slabs, ``vals [B, N]`` f32 and ``fields [B, N]``
    i32 (−1 = padding) → ``[B, F(F+1)/2]`` f32."""
    if emb.device.type == "cpu":
        return ffm_triangle_reference(emb, vals, fields, F, k)
    if emb.device.type != "cuda":
        raise ValueError(f"ffm_triangle runs on CUDA or CPU tensors, not "
                         f"{emb.device.type}")
    _check(emb, vals, fields, F, k, backward=False)
    global LAUNCHES
    B, N = emb.shape[:2]
    out = torch.empty((B, F * (F + 1) // 2), dtype=torch.float32,
                      device=emb.device)
    if B == 0:
        return out
    lib = build.load("ffm_triangle")
    stream = torch.cuda.current_stream(emb.device).cuda_stream
    rc = lib.fwt_ffm_triangle(emb.data_ptr(), vals.data_ptr(),
                              fields.data_ptr(), out.data_ptr(),
                              B, N, F, k, stream)
    build.check(lib, rc, "ffm_triangle")
    with _count_lock:
        LAUNCHES += 1
    return out


def ffm_triangle_bwd_reference(g_out: torch.Tensor, emb: torch.Tensor,
                               vals: torch.Tensor, fields: torch.Tensor,
                               F: int, k: int) -> torch.Tensor:
    """Plain version of the backward: torch autograd through
    :func:`ffm_triangle_reference` → ``d emb [B, N, F·k]``."""
    with torch.enable_grad():
        e = emb.detach().requires_grad_(True)
        out = ffm_triangle_reference(e, vals, fields, F, k)
        (d_emb,) = torch.autograd.grad(out, e, g_out)
    return d_emb


def ffm_triangle_bwd(g_out: torch.Tensor, emb: torch.Tensor, vals: torch.Tensor,
                     fields: torch.Tensor, F: int, k: int) -> torch.Tensor:
    """Gradient of :func:`ffm_triangle` with respect to ``emb``: ``g_out
    [B, F(F+1)/2]`` f32 → ``[B, N, F·k]`` f32. Padded positions get 0."""
    if emb.device.type == "cpu":
        return ffm_triangle_bwd_reference(g_out, emb, vals, fields, F, k)
    if emb.device.type != "cuda":
        raise ValueError(f"ffm_triangle_bwd runs on CUDA or CPU tensors, not "
                         f"{emb.device.type}")
    _check(emb, vals, fields, F, k, backward=True)
    B, N = emb.shape[:2]
    T = F * (F + 1) // 2
    if tuple(g_out.shape) != (B, T) or g_out.dtype != torch.float32 \
            or g_out.device != emb.device or not g_out.is_contiguous():
        raise ValueError(f"g_out must be a contiguous float32 [B, {T}] tensor "
                         f"on {emb.device}, got {tuple(g_out.shape)} "
                         f"{g_out.dtype} on {g_out.device}")
    global BWD_LAUNCHES
    d_emb = torch.empty_like(emb)
    if B == 0 or N == 0:
        return d_emb
    lib = build.load("ffm_triangle")
    stream = torch.cuda.current_stream(emb.device).cuda_stream
    rc = lib.fwt_ffm_triangle_bwd(g_out.data_ptr(), emb.data_ptr(),
                                  vals.data_ptr(), fields.data_ptr(),
                                  d_emb.data_ptr(), B, N, F, k, stream)
    build.check(lib, rc, "ffm_triangle_bwd")
    with _count_lock:
        BWD_LAUNCHES += 1
    return d_emb


class FfmTriangle(torch.autograd.Function):
    """:func:`ffm_triangle` with :func:`ffm_triangle_bwd` as its backward;
    the gradient flows to ``emb`` only."""

    @staticmethod
    def forward(ctx, emb, vals, fields, F: int, k: int):
        ctx.save_for_backward(emb, vals, fields)
        ctx.F, ctx.k = F, k
        return ffm_triangle(emb, vals, fields, F, k)

    @staticmethod
    def backward(ctx, g_out):
        emb, vals, fields = ctx.saved_tensors
        d_emb = ffm_triangle_bwd(g_out.contiguous(), emb, vals, fields,
                                 ctx.F, ctx.k)
        return d_emb, None, None, None, None
