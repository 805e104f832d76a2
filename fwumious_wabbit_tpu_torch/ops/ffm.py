"""FFM field-pair interactions with the slab gather fused in — the
counterpart of fwumious_wabbit_tpu/ops/pallas/ffm.py and of the gather
before it (ops/tables.py ``gather``).

:func:`ffm_fused` computes, per example, from the flat FFM table, the
feature ids and their values and fields (e[n] = feature n's slab, gathered
by :func:`tables.gather`'s rule),

    C[t,f,:]    = Σ_{n: field(n)=f} v_n · e[n, t·k:(t+1)·k]
    inter[t,f]  = ½⟨C[t,f,:], C[f,t,:]⟩ − [t=f]·½Σ_{n∈t} v_n²‖e[n, t·k:(t+1)·k]‖²
    out[tri(i,j)] = inter[i,j] · (2 if j < i else 1)   (row-major lower triangle)

On a CUDA tensor it launches the hand-written kernel in
``csrc/ffm_triangle.cu`` (built on first use), which reads each slab
straight from the table, or raises; there is no fallback. On a CPU tensor it
runs the plain PyTorch version: :func:`tables.gather` followed by
:func:`ffm_triangle_reference`, which mirrors the JAX model's unfused path
(fwumious_wabbit_tpu/models/model.py:418-443).

:func:`ffm_fused_bwd` is its gradient with respect to the gathered slabs
``d emb [B, N, F·k]`` (the JAX package takes it from ``jax.vjp``): a second
hand-written kernel in the same source on a CUDA tensor, torch autograd
through the plain version on a CPU tensor. :class:`FfmFused` joins the two
as a ``torch.autograd.Function`` whose gradient flows to a stride-0 leaf of
the slabs' shape (:func:`slab_leaf`): the train step takes ``d emb`` from
it, and the slabs themselves are never materialized on the card.

Both launch on the current stream (the backward on the one autograd gives
it, the forward's) and neither synchronises, so a CUDA graph captures them
(train/packed.py); the library and the card's SM count must already be
loaded when a capture begins.
"""

from __future__ import annotations

import functools
import threading
from dataclasses import dataclass

import torch

from . import tables
from .kernels import build

# kernel launches made by ffm_fused and ffm_fused_bwd (CUDA tensors only);
# a CUDA graph's replay adds the launches it captured (add_launches)
LAUNCHES = 0
BWD_LAUNCHES = 0
_count_lock = threading.Lock()
# what a CUDA graph's capture counts as its own (train/step.py): the
# capturing thread's launches, and any thread's made on a stream while it
# captured — autograd runs the backward on a thread of its own, on the
# capturing stream; captures run one at a time. Not the daemon's other
# threads', which launch meanwhile on their own streams
_thread = threading.local()
_captured = [0, 0]


def add_launches(fwd: int, bwd: int) -> None:
    """Count ``fwd`` forward and ``bwd`` backward launches: a wrapper's
    own, or a replayed graph's (train/step.py), in the process's counters
    and the calling thread's (:func:`own_launches`)."""
    global LAUNCHES, BWD_LAUNCHES
    with _count_lock:
        LAUNCHES += fwd
        BWD_LAUNCHES += bwd
    counts = getattr(_thread, "counts", (0, 0))
    _thread.counts = (counts[0] + fwd, counts[1] + bwd)


def _count(fwd: int, bwd: int) -> None:
    """A wrapper's launch; on a stream that is capturing a graph, the
    capture's."""
    global LAUNCHES, BWD_LAUNCHES
    if not torch.cuda.is_current_stream_capturing():
        add_launches(fwd, bwd)
        return
    with _count_lock:
        LAUNCHES += fwd
        BWD_LAUNCHES += bwd
        _captured[0] += fwd
        _captured[1] += bwd


def own_launches() -> tuple:
    """``(forward, backward)`` launches a capture on the calling thread
    counts as its own: the thread's, and those made on a capturing
    stream."""
    counts = getattr(_thread, "counts", (0, 0))
    with _count_lock:
        return counts[0] + _captured[0], counts[1] + _captured[1]


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


def _pairwise(terms: list) -> torch.Tensor:
    """``(t0 + t1) + (t2 + t3) …``, level by level, an odd last term
    carried up."""
    while len(terms) > 1:
        pairs = [terms[i] + terms[i + 1] for i in range(0, len(terms) - 1, 2)]
        terms = pairs + terms[len(terms) - len(terms) % 2:]
    return terms[0]


def field_sums(onehot: torch.Tensor, weighted: torch.Tensor) -> torch.Tensor:
    """``C[b,t,f,:] = Σ_n onehot[b,n,f] · weighted[b,n,t,:]``, added in the
    order of the JAX model's ``einsum("bnf,bntk->btfk")`` on XLA's CPU
    backend: four running sums over the first 4⌊N/4⌋ features (feature n
    into sum n mod 4), joined pairwise, plus the pairwise sum of the rest.
    The products are exact (a one-hot times a weighted slab), so only the
    order of the adds can move a last bit of C, and with it of every
    gradient autograd takes through C (tests/test_torch_ffm.py holds the
    order against ``jnp.einsum`` at F = 2, 3 and 4 for N up to 48;
    ``torch.einsum`` adds in feature order)."""
    terms = onehot[:, :, None, :, None] * weighted[:, :, :, None, :]  # [B,N,T,F,k]
    N = terms.shape[1]
    M = N - N % 4
    parts = []
    if M:
        acc = terms[:, 0:4]
        for i in range(4, M, 4):
            acc = acc + terms[:, i:i + 4]
        parts.append(_pairwise(list(acc.unbind(1))))
    if N > M:
        parts.append(_pairwise(list(terms[:, M:].unbind(1))))
    return _pairwise(parts)


def _sum_in_order(p: torch.Tensor) -> torch.Tensor:
    """``Σ_k p[..., k]`` added in order, as XLA's CPU reduce adds a
    ``jnp.sum`` over the last axis (``Tensor.sum`` differs from k = 9 on)."""
    out = p[..., 0]
    for i in range(1, p.shape[-1]):
        out = out + p[..., i]
    return out


def _fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """``a·b + c`` rounded once, as a fused multiply-add: the product is
    exact in float64, and the sum is exact there too unless the exponents
    of ``a·b`` and ``c`` lie more than 29 bits apart."""
    return (a.double() * b.double() + c.double()).to(a.dtype)


def k_dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``Σ_k a[..., k]·b[..., k]`` in the order of the JAX model's
    ``einsum("btfk,bftk->btf")`` on XLA's CPU backend: the first
    ``min(k, 8)`` products rounded and added in order, then each later
    product fused onto the sum (one rounding); at k = 2 the second
    product is fused onto the first (tests/test_torch_ffm.py holds the
    order bit for bit against ``jnp.einsum`` for k up to 17;
    ``torch.einsum`` differs at k = 2 and from k = 9 on)."""
    k = a.shape[-1]
    if k == 2:
        return _fma(a[..., 1], b[..., 1], a[..., 0] * b[..., 0])
    out = _sum_in_order(a[..., :8] * b[..., :8])
    for i in range(8, k):
        out = _fma(a[..., i], b[..., i], out)
    return out


def ffm_triangle_reference(emb: torch.Tensor, vals: torch.Tensor,
                           fields: torch.Tensor, F: int, k: int) -> torch.Tensor:
    """Plain PyTorch version: ``[B, N, F·k]`` slabs → ``[B, F(F+1)/2]``.
    A field outside ``[0, F)`` (−1 padding) maps to the zero one-hot row."""
    B, N, _ = emb.shape
    e = emb.reshape(B, N, F, k)  # e[b,n,t,:] = w_n→t
    onehot = (fields.long().unsqueeze(-1)
              == torch.arange(F, device=emb.device)).to(emb.dtype)  # [B,N,F]
    weighted = e * vals[:, :, None, None]
    C = field_sums(onehot, weighted)
    inter = 0.5 * k_dot(C, C.transpose(1, 2))
    own = torch.einsum("bntk,bnt->bnk", e, onehot)  # w_n→field(n)
    self_term = 0.5 * _sum_in_order(own * own) * vals * vals  # [B,N]
    diag = torch.einsum("bn,bnf->bf", self_term, onehot)  # [B,F]
    inter = inter - torch.diag_embed(diag)
    ti, tj, scale = triangle_indices(F)
    return inter[:, ti, tj] * torch.tensor(scale, dtype=emb.dtype,
                                           device=emb.device)


def ffm_triangle_bwd_reference(g_out: torch.Tensor, emb: torch.Tensor,
                               vals: torch.Tensor, fields: torch.Tensor,
                               F: int, k: int) -> torch.Tensor:
    """Torch autograd through :func:`ffm_triangle_reference` →
    ``d emb [B, N, F·k]``."""
    with torch.enable_grad():
        e = emb.detach().requires_grad_(True)
        out = ffm_triangle_reference(e, vals, fields, F, k)
        (d_emb,) = torch.autograd.grad(out, e, g_out)
    return d_emb


def ffm_fused_reference(table: torch.Tensor, ids: torch.Tensor,
                        vals: torch.Tensor, fields: torch.Tensor, F: int,
                        k: int, spec: tables.TableSpec) -> torch.Tensor:
    """Plain version of :func:`ffm_fused`: the gather, then the triangle."""
    return ffm_triangle_reference(tables.gather(table, ids, spec), vals, fields,
                                  F, k)


def ffm_fused_bwd_reference(g_out: torch.Tensor, table: torch.Tensor,
                            ids: torch.Tensor, vals: torch.Tensor,
                            fields: torch.Tensor, F: int, k: int,
                            spec: tables.TableSpec) -> torch.Tensor:
    """Plain version of :func:`ffm_fused_bwd`: the gather, then autograd
    through :func:`ffm_triangle_reference`."""
    return ffm_triangle_bwd_reference(g_out, tables.gather(table, ids, spec),
                                      vals, fields, F, k)


# the kernels' launch geometry (csrc/ffm_triangle.cu): threads per block,
# index and slab ring stages, the contra floats a tile aims at, the most
# examples per tile, and the slab bytes one ring stage aims at
THREADS = 256
IDX_STAGES = 4
SLAB_STAGES = 3
TILE_FLOATS = 1024
MAX_TILE = 32
STAGE_BYTES = 16384


def _round4(n: int) -> int:
    return (n + 3) & ~3


def smem_words(backward: bool, F: int, k: int, tile: int, chunk: int,
               staged: bool) -> int:
    """4-byte words of shared memory one block of the forward or the
    backward kernel uses (the kernel's ``layout``): C ``[tile, F, F, k]``;
    IDX_STAGES stages of a chunk's
    ids, values and fields, each with 4 words of slack; staged backward,
    IDX_STAGES stages of the tile's g_out rows; staged, SLAB_STAGES ring
    stages of the chunk's slabs, each padded to 16 bytes."""
    T = F * (F + 1) // 2
    words = _round4(tile * F * F * k)
    words += IDX_STAGES * 3 * _round4(chunk + 4)
    if staged:
        if backward:
            words += IDX_STAGES * _round4(tile * T + 4)
        words += SLAB_STAGES * chunk * _round4(F * k)
    return words


@dataclass(frozen=True)
class Geometry:
    """One launch of an FFM kernel: ``tile`` examples per tile, ``chunk``
    positions per ring stage (a whole tile's, or part of one example's
    when its slabs outgrow a stage), ``staged`` whether slabs (and g_out)
    go through shared memory, ``vec`` floats per slab copy, ``smem`` bytes
    of shared memory per block."""
    tile: int
    chunk: int
    staged: bool
    vec: int
    smem: int

    def tiles(self, B: int) -> int:
        return -(-B // self.tile)


@functools.lru_cache(maxsize=512)
def geometry(F: int, k: int, N: int, backward: bool = False,
             table_align: int = 16, B: int | None = None,
             sms: int | None = None) -> Geometry:
    """The kernels' geometry at (F, k, N). A tile holds about TILE_FLOATS
    contra floats (TILE_FLOATS // (F·F·k) examples, 1 to MAX_TILE); given
    the batch ``B`` and the card's ``sms``, no more than B / sms examples,
    so that a small batch still spreads over every SM; and no more slabs
    than one STAGE_BYTES ring stage. Where one example's slabs outgrow a
    stage, a tile is one example streamed in chunks. Slab copies are 16
    bytes where F·k % 4 == 0 and the table (``table_align`` bytes) allows,
    else 8 or 4. Where the ring does not fit beside C under the card's
    227 KB, slabs and g_out are read from global memory instead. Raises
    ValueError where even C and the index stages do not fit."""
    Fk = F * k
    slab = _round4(Fk) * 4
    tile = max(1, min(MAX_TILE, TILE_FLOATS // (F * Fk)))
    if B is not None and sms:
        tile = min(tile, max(1, -(-B // sms)))
    tile = max(1, min(tile, STAGE_BYTES // max(1, N * slab)))
    chunk = (max(1, tile * N) if tile * N * slab <= STAGE_BYTES
             else max(1, STAGE_BYTES // slab))
    if table_align % 16 == 0 and Fk % 4 == 0:
        vec = 4
    elif table_align % 8 == 0 and Fk % 2 == 0:
        vec = 2
    else:
        vec = 1
    for staged in (True, False):
        smem = 4 * smem_words(backward, F, k, tile, chunk, staged)
        if smem <= SMEM_LIMIT_BYTES:
            return Geometry(tile, chunk, staged, vec, smem)
    raise ValueError(
        f"F={F}, k={k} needs {smem} bytes of shared memory per block in the "
        f"FFM {'backward' if backward else 'forward'} kernel; the limit is "
        f"{SMEM_LIMIT_BYTES} bytes (227 KB)")


def table_alignment(table: torch.Tensor) -> int:
    """The largest of 16, 8 and 4 bytes that the table's address is a
    multiple of."""
    p = table.data_ptr()
    return 16 if p % 16 == 0 else 8 if p % 8 == 0 else 4


@functools.lru_cache(maxsize=16)
def sm_count(device: int) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def launch_geometry(table: torch.Tensor, B: int, N: int, F: int, k: int,
                    backward: bool) -> Geometry:
    """The geometry of one launch on ``table``'s card; the kernel launches
    one block per tile (``geo.tiles(B)``)."""
    return geometry(F, k, N, backward, table_alignment(table), B,
                    sm_count(table.device.index))


def slab_mask(spec: tables.TableSpec) -> int:
    """The kernels' ``base = id & mask`` (:func:`tables.gather`'s rule) as a
    signed 32-bit int: the id's aligned window, or its whole row when a
    slab spans rows."""
    return ~(spec.align - 1) if spec.rows_per_slab == 1 else ~(tables.LANE - 1)


def _check(table, ids, vals, fields, F, k, spec, backward: bool) -> Geometry:
    if spec.slab != F * k:
        raise ValueError(f"the table's slab is {spec.slab} floats, not F*k={F * k}")
    if table.dim() != 2 or tuple(table.shape) != (spec.num_rows, tables.LANE):
        raise ValueError(f"table must be [{spec.num_rows}, {tables.LANE}], got "
                         f"{tuple(table.shape)}")
    if ids.dim() != 2:
        raise ValueError(f"ids must be [B, N], got {tuple(ids.shape)}")
    if tuple(vals.shape) != tuple(ids.shape) or tuple(fields.shape) != tuple(ids.shape):
        raise ValueError(f"ids, vals and fields must be [B, N]={tuple(ids.shape)}, "
                         f"got {tuple(vals.shape)} and {tuple(fields.shape)}")
    if table.dtype != torch.float32 or vals.dtype != torch.float32:
        raise TypeError("table and vals must be float32")
    if ids.dtype != torch.int32 or fields.dtype != torch.int32:
        raise TypeError("ids and fields must be int32")
    if not (table.device == ids.device == vals.device == fields.device):
        raise ValueError("table, ids, vals and fields must be on one device")
    if not all(t.is_contiguous() for t in (table, ids, vals, fields)):
        raise ValueError("table, ids, vals and fields must be contiguous")
    if table.device.index != torch.cuda.current_device():
        raise ValueError(f"the FFM kernels launch on the current device "
                         f"cuda:{torch.cuda.current_device()}, not {table.device}")
    return launch_geometry(table, *ids.shape, F, k, backward)


def _launch_args(geo: Geometry, table: torch.Tensor) -> tuple:
    """The launchers' trailing arguments: the geometry and the current
    stream."""
    return (geo.tile, geo.chunk, int(geo.staged), geo.vec, geo.smem,
            torch.cuda.current_stream(table.device).cuda_stream)


def _on_cuda(table: torch.Tensor, what: str) -> bool:
    if table.device.type == "cpu":
        return False
    if table.device.type != "cuda":
        raise ValueError(f"{what} runs on CUDA or CPU tensors, not "
                         f"{table.device.type}")
    return True


def ffm_fused(table: torch.Tensor, ids: torch.Tensor, vals: torch.Tensor,
              fields: torch.Tensor, F: int, k: int,
              spec: tables.TableSpec) -> torch.Tensor:
    """The FFM ``[num_rows, 128]`` f32 table, ``ids [B, N]`` i32, ``vals
    [B, N]`` f32 and ``fields [B, N]`` i32 (−1 = padding) →
    ``[B, F(F+1)/2]`` f32."""
    if not _on_cuda(table, "ffm_fused"):
        return ffm_fused_reference(table, ids, vals, fields, F, k, spec)
    geo = _check(table, ids, vals, fields, F, k, spec, backward=False)
    B, N = ids.shape
    out = torch.empty((B, F * (F + 1) // 2), dtype=torch.float32,
                      device=table.device)
    if B == 0:
        return out
    lib = build.load("ffm_triangle")
    rc = lib.fwt_ffm_fused(table.data_ptr(), ids.data_ptr(), vals.data_ptr(),
                           fields.data_ptr(), out.data_ptr(), B, N, F, k,
                           slab_mask(spec), *_launch_args(geo, table))
    build.check(lib, rc, "ffm_fused")
    _count(1, 0)
    return out


def ffm_fused_bwd(g_out: torch.Tensor, table: torch.Tensor, ids: torch.Tensor,
                  vals: torch.Tensor, fields: torch.Tensor, F: int, k: int,
                  spec: tables.TableSpec) -> torch.Tensor:
    """Gradient of :func:`ffm_fused` with respect to the gathered slabs:
    ``g_out [B, F(F+1)/2]`` f32 → ``d emb [B, N, F·k]`` f32, the layout
    train/step.ffm_update_rows takes. Padded positions get 0."""
    if not _on_cuda(table, "ffm_fused_bwd"):
        return ffm_fused_bwd_reference(g_out, table, ids, vals, fields, F, k,
                                       spec)
    geo = _check(table, ids, vals, fields, F, k, spec, backward=True)
    B, N = ids.shape
    T = F * (F + 1) // 2
    if tuple(g_out.shape) != (B, T) or g_out.dtype != torch.float32 \
            or g_out.device != table.device or not g_out.is_contiguous():
        raise ValueError(f"g_out must be a contiguous float32 [B, {T}] tensor "
                         f"on {table.device}, got {tuple(g_out.shape)} "
                         f"{g_out.dtype} on {g_out.device}")
    d_emb = torch.empty((B, N, F * k), dtype=torch.float32, device=table.device)
    if B == 0 or N == 0:
        return d_emb
    lib = build.load("ffm_triangle")
    rc = lib.fwt_ffm_fused_bwd(g_out.data_ptr(), table.data_ptr(), ids.data_ptr(),
                               vals.data_ptr(), fields.data_ptr(),
                               d_emb.data_ptr(), B, N, F, k, slab_mask(spec),
                               *_launch_args(geo, table))
    build.check(lib, rc, "ffm_fused_bwd")
    _count(0, 1)
    return d_emb


def slab_leaf(ids: torch.Tensor, F: int, k: int) -> torch.Tensor:
    """A leaf of the gathered slabs' shape ``[B, N, F·k]`` that holds no
    slabs (one zero, expanded with stride 0) and requires grad: the
    gradient :class:`FfmFused` returns for it is ``d emb``."""
    B, N = ids.shape
    zero = torch.zeros((), dtype=torch.float32, device=ids.device)
    return zero.expand(B, N, F * k).requires_grad_(True)


class FfmFused(torch.autograd.Function):
    """:func:`ffm_fused` with :func:`ffm_fused_bwd` as its backward. The
    first argument is a :func:`slab_leaf` (or None, for no gradient); the
    gradient flows to it only, never to the table."""

    @staticmethod
    def forward(ctx, emb_leaf, table, ids, vals, fields, F: int, k: int,
                spec: tables.TableSpec):
        ctx.save_for_backward(table, ids, vals, fields)
        ctx.F, ctx.k, ctx.spec = F, k, spec
        return ffm_fused(table, ids, vals, fields, F, k, spec)

    @staticmethod
    def backward(ctx, g_out):
        table, ids, vals, fields = ctx.saved_tensors
        d_emb = ffm_fused_bwd(g_out.contiguous(), table, ids, vals, fields,
                              ctx.F, ctx.k, ctx.spec)
        return d_emb, None, None, None, None, None, None, None
