"""Block-sparse × block-sparse tile kernels — the counterparts of the
JAX package's registry kernels in ``matrel_tpu/ops/kernel_registry.py``:
B4 ``_make_pair_kernel`` (``pallas_generic``), B5
``_make_grouped_kernel`` (``pallas_cluster``, and ``pallas_band``'s
fallback), B6 ``_build_band``'s strip kernel (``pallas_band``) and B7
``_build_bucketed`` (``pallas_powerlaw``).

Every kernel computes part of one output tile stack
``out[slot] = Σ A[ia] @ B[ib]`` over the pairs of that slot, in f32, and
differs only in how a slot's pairs are listed:

- B4 :func:`spgemm_pairs` — the slot-sorted pair list ``pa``/``pb``
  with a CSR pointer ``slot_ptr`` over slots;
- B5 :func:`spgemm_grouped` — the grouped layout of
  ``kernel_registry._grouped_tables``: ``group_slot`` (sorted) names
  each group's slot and ``src`` its G pair positions, where ``src ==
  npairs`` pads a slot's run to a multiple of G;
- B6 :func:`spgemm_band` — the band tables of ``_build_band``: per
  slot the strip position ``sel``, per A block row the ``wa`` A tiles
  ``a_idx`` and per (row, band column) the B tiles ``b_idx``; index
  ``nA`` / ``nB`` names the zero tile;
- B7 :func:`spgemm_powerlaw` — B5 once per non-empty bucket on the
  bucket's local slots, written into the full stack through ``ids``.

On a CUDA tensor each wrapper launches the hand-written Hopper kernel
in ``csrc/spgemm_registry.cu`` (built at first use, loaded with ctypes;
bf16 tiles through the body :mod:`tile_body` chooses by shape, the
``wgmma`` body of ``csrc/bf16_tile_wgmma.cuh`` or the WMMA one) and
counts the launch; on a CPU tensor it runs the plain PyTorch
version beside it (``*_plain``), which reads the same tables: gather →
batched f32 matmul (TF32 off) → ``index_add_`` in f32 → cast. A CUDA
tensor launches the kernel or raises. The payload tables are read in
place: nothing is pre-gathered into grouped copies.
"""

from __future__ import annotations

import ctypes
from typing import Callable, Optional, Sequence

import torch

from matrel_tpu_torch.ops import tile_body

Tensor = torch.Tensor

#: Kernel launches of each wrapper, counted where the kernel is launched
#: and nowhere else. B7 counts its bucket launches under its own name.
#: BODY_LAUNCHES counts the launches of all four by tile body.
LAUNCHES_PAIRS = 0
LAUNCHES_GROUPED = 0
LAUNCHES_BAND = 0
LAUNCHES_POWERLAW = 0
BODY_LAUNCHES = dict.fromkeys(tile_body.CODES, 0)

SOURCE = "spgemm_registry.cu"

_DTYPES = (torch.float32, torch.bfloat16)

#: Pair × tile elements per step of the plain versions (and of the
#: ``xla_gather`` composite): bounds each gathered operand to 64 MiB f32.
_PLAIN_CHUNK_ELEMS = 1 << 24


def _library() -> ctypes.CDLL:
    from matrel_tpu_torch.utils import cuda_build
    lib = cuda_build.load(SOURCE)
    if lib.matrel_spgemm_pairs.argtypes is None:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.matrel_spgemm_pairs.argtypes = [p, p, p, p, p, p, ll, ll, ll,
                                            i, i, i, i, i, p]
        lib.matrel_spgemm_grouped.argtypes = [p, p, p, p, p, p, p, p, ll,
                                              ll, ll, i, i, i, i, i, i, i,
                                              i, i, p]
        lib.matrel_spgemm_band.argtypes = [p, p, p, p, p, p, ll, i, i, i,
                                           i, i, i, i, i, i, p]
        for fn in (lib.matrel_spgemm_pairs, lib.matrel_spgemm_grouped,
                   lib.matrel_spgemm_band):
            fn.restype = ctypes.c_int
    return lib


def build() -> None:
    """Compile (if needed) and load the kernel library."""
    _library()


# -- plain versions -----------------------------------------------------------


def f32_bmm(p: Tensor, q: Tensor) -> Tensor:
    """Batched tile product in full f32 (TF32 off): the counterpart of
    ``Precision.HIGHEST`` (bf16 operands widen exactly)."""
    from matrel_tpu_torch.parallel.strategies import _highest_precision
    _highest_precision()
    return torch.bmm(p.float(), q.float())


def accumulate_pairs(acc: Tensor, a: Tensor, b: Tensor, ia: Tensor,
                     ib: Tensor, dst: Tensor,
                     mm: Callable[[Tensor, Tensor], Tensor] = f32_bmm
                     ) -> Tensor:
    """``acc[dst[t]] += mm(a[ia[t]], b[ib[t]])`` for every t, in chunks
    of about 64 MiB of gathered tiles; ``acc`` is f32."""
    bs = a.shape[1]
    step = max(1, _PLAIN_CHUNK_ELEMS // (bs * bs))
    ia, ib, dst = ia.long(), ib.long(), dst.long()
    for s in range(0, ia.numel(), step):
        acc.index_add_(0, dst[s:s + step],
                       mm(a.index_select(0, ia[s:s + step]),
                          b.index_select(0, ib[s:s + step])))
    return acc


def _acc(n: int, a: Tensor) -> Tensor:
    bs = a.shape[1]
    return torch.zeros((n, bs, bs), dtype=torch.float32, device=a.device)


def spgemm_pairs_plain(a: Tensor, b: Tensor, slot_ptr: Tensor, pa: Tensor,
                       pb: Tensor) -> Tensor:
    """Plain B4 over the pair CSR: pair t of slot s (``slot_ptr[s] <= t <
    slot_ptr[s+1]``) adds ``a[pa[t]] @ b[pb[t]]`` into ``out[s]``."""
    n_out = slot_ptr.numel() - 1
    counts = (slot_ptr[1:] - slot_ptr[:-1]).long()
    slot = torch.repeat_interleave(
        torch.arange(n_out, device=a.device), counts)
    return accumulate_pairs(_acc(n_out, a), a, b, pa, pb, slot).to(a.dtype)


def spgemm_grouped_plain(a: Tensor, b: Tensor, src: Tensor,
                         group_slot: Tensor, pa: Tensor, pb: Tensor,
                         group: int, n_slots: int) -> Tensor:
    """Plain B5 over the grouped layout: position j (group ``j //
    group`` of slot ``group_slot[j // group]``) adds pair ``src[j]``;
    padding positions (``src[j] == npairs``) add nothing."""
    npairs = pa.numel()
    slot = torch.repeat_interleave(group_slot.long(), group)
    live = src < npairs
    p = src[live].long()
    return accumulate_pairs(_acc(n_slots, a), a, b, pa[p], pb[p],
                            slot[live]).to(a.dtype)


def spgemm_band_plain(a: Tensor, b: Tensor, a_idx: Tensor, b_idx: Tensor,
                      sel: Tensor, wa: int, width: int) -> Tensor:
    """Plain B6 over the band tables: slot s is band position ``sel[s] =
    i·width + c`` of A block row i, and adds ``a[a_idx[i, w]] @
    b[b_idx[i, w, c]]`` for w < wa; index ``nA`` / ``nB`` is the zero
    tile and adds nothing."""
    n_out = sel.numel()
    i = sel.long() // width
    c = sel.long() % width
    a2 = a_idx.long().view(-1, wa)
    b3 = b_idx.long().view(-1, wa, width)
    slot = torch.arange(n_out, device=a.device)
    acc = _acc(n_out, a)
    for w in range(wa):
        ia, ib = a2[i, w], b3[i, w, c]
        live = (ia < a.shape[0]) & (ib < b.shape[0])
        accumulate_pairs(acc, a, b, ia[live], ib[live], slot[live])
    return acc.to(a.dtype)


# -- kernel wrappers ----------------------------------------------------------


def _check(a: Tensor, b: Tensor, tables: Sequence[Tensor]) -> None:
    for name, t in (("a", a), ("b", b)):
        if t.dim() != 3 or t.shape[1] != t.shape[2]:
            raise ValueError(f"{name} must be a [n, bs, bs] tile stack, got "
                             f"{tuple(t.shape)}")
    if a.shape[1] != b.shape[1]:
        raise ValueError(f"tile sizes differ: {a.shape[1]} vs {b.shape[1]}")
    if a.dtype not in _DTYPES or b.dtype != a.dtype:
        raise TypeError(f"payload dtypes {a.dtype}, {b.dtype}: both must be "
                        f"float32 or both bfloat16")
    if any(t.dtype != torch.int32 or t.dim() != 1 for t in tables):
        raise TypeError("index tables must be 1D int32 tensors")
    devs = {t.device for t in (a, b, *tables)}
    if len(devs) != 1:
        raise ValueError(f"operands on different devices: "
                         f"{sorted(map(str, devs))}")
    if not all(t.is_contiguous() for t in (a, b, *tables)):
        raise ValueError("spgemm kernels need contiguous tensors")


def body(a: Tensor, b: Tensor, out: Tensor) -> str:
    """The tile body a launch over these stacks runs
    (:func:`tile_body.body_of`; the output's columns are ``bs``)."""
    bs = a.shape[1]
    return tile_body.body_of(a.dtype, bs, bs, a, b, out)


def _cuda_args(a: Tensor, b: Tensor, out: Tensor):
    """(body, body code, a_vec, b_vec, device index, stream) of one
    launch; the vec flags allow the WMMA and f32 bodies 16-byte loads
    (rows a multiple of 16 bytes, aligned stacks)."""
    dev = a.device
    if dev.type != "cuda":
        raise ValueError(f"spgemm kernels run on CUDA or CPU tensors, got "
                         f"{dev}")
    bs = a.shape[1]
    vec = 16 // a.element_size()
    a_vec = int(bs % vec == 0 and a.data_ptr() % 16 == 0)
    b_vec = int(bs % vec == 0 and b.data_ptr() % 16 == 0)
    stream = torch.cuda.current_stream(dev).cuda_stream
    chosen = body(a, b, out)
    return (chosen, tile_body.CODES[chosen], a_vec, b_vec, dev.index,
            stream)


def spgemm_pairs(a: Tensor, b: Tensor, slot_ptr: Tensor, pa: Tensor,
                 pb: Tensor) -> Tensor:
    """B4: the [n_out, bs, bs] tile stack of the slot-sorted pair list
    (``slot_ptr`` [n_out + 1] int32 over ``pa``/``pb``), in the payload
    dtype."""
    global LAUNCHES_PAIRS
    _check(a, b, (slot_ptr, pa, pb))
    if a.device.type == "cpu":
        return spgemm_pairs_plain(a, b, slot_ptr, pa, pb)
    n_out, bs = slot_ptr.numel() - 1, a.shape[1]
    out = torch.empty((n_out, bs, bs), dtype=a.dtype, device=a.device)
    chosen, code, a_vec, b_vec, idx, stream = _cuda_args(a, b, out)
    with torch.cuda.device(a.device):
        rc = _library().matrel_spgemm_pairs(
            a.data_ptr(), b.data_ptr(), out.data_ptr(), slot_ptr.data_ptr(),
            pa.data_ptr(), pb.data_ptr(), n_out, a.shape[0], b.shape[0], bs,
            code, a_vec, b_vec, idx, stream)
    tile_body.raise_on(rc, f"spgemm_pairs ({chosen} body)")
    LAUNCHES_PAIRS += 1
    BODY_LAUNCHES[chosen] += 1
    return out


def _launch_grouped(a, b, src, group_slot, pa, pb, group, n_slots, out,
                    ids: Optional[Tensor]) -> None:
    chosen, code, a_vec, b_vec, idx, stream = _cuda_args(a, b, out)
    bs = a.shape[1]
    with torch.cuda.device(a.device):
        rc = _library().matrel_spgemm_grouped(
            a.data_ptr(), b.data_ptr(), out.data_ptr(), src.data_ptr(),
            group_slot.data_ptr(), pa.data_ptr(), pb.data_ptr(),
            0 if ids is None else ids.data_ptr(), n_slots, a.shape[0],
            b.shape[0], group_slot.numel(), group, pa.numel(), out.shape[0],
            bs, code, a_vec, b_vec, idx, stream)
    tile_body.raise_on(rc, f"spgemm_grouped ({chosen} body)")
    BODY_LAUNCHES[chosen] += 1


def _check_grouped(a, b, src, group_slot, pa, pb, group):
    _check(a, b, (src, group_slot, pa, pb))
    if src.numel() != group_slot.numel() * group:
        raise ValueError(f"src holds {src.numel()} positions, want "
                         f"{group_slot.numel()} groups x {group}")


def spgemm_grouped(a: Tensor, b: Tensor, src: Tensor, group_slot: Tensor,
                   pa: Tensor, pb: Tensor, group: int,
                   n_slots: int) -> Tensor:
    """B5: the [n_slots, bs, bs] tile stack of the grouped layout (every
    slot owns at least one group, as ``_grouped_tables`` builds it)."""
    global LAUNCHES_GROUPED
    _check_grouped(a, b, src, group_slot, pa, pb, group)
    if a.device.type == "cpu":
        return spgemm_grouped_plain(a, b, src, group_slot, pa, pb, group,
                                    n_slots)
    bs = a.shape[1]
    out = torch.empty((n_slots, bs, bs), dtype=a.dtype, device=a.device)
    _launch_grouped(a, b, src, group_slot, pa, pb, group, n_slots, out, None)
    LAUNCHES_GROUPED += 1
    return out


def spgemm_powerlaw(a: Tensor, b: Tensor, buckets: Sequence[dict],
                    n_out: int) -> Tensor:
    """B7: the [n_out, bs, bs] tile stack from B5 run once per bucket —
    each bucket a dict of device tables ``src``, ``group_slot``, ``pa``,
    ``pb`` (its own compacted pair list), its ``group`` and ``ids``
    (local slot → output slot). The buckets partition the output slots,
    so every tile is written by exactly one launch."""
    global LAUNCHES_POWERLAW
    for bk in buckets:
        _check_grouped(a, b, bk["src"], bk["group_slot"], bk["pa"],
                       bk["pb"], bk["group"])
        _check(a, b, (bk["ids"],))
    bs = a.shape[1]
    if a.device.type == "cpu":
        out = torch.zeros((n_out, bs, bs), dtype=a.dtype, device=a.device)
        for bk in buckets:
            out[bk["ids"].long()] = spgemm_grouped_plain(
                a, b, bk["src"], bk["group_slot"], bk["pa"], bk["pb"],
                bk["group"], bk["ids"].numel())
        return out
    out = torch.empty((n_out, bs, bs), dtype=a.dtype, device=a.device)
    for bk in buckets:
        _launch_grouped(a, b, bk["src"], bk["group_slot"], bk["pa"],
                        bk["pb"], bk["group"], bk["ids"].numel(), out,
                        bk["ids"])
        LAUNCHES_POWERLAW += 1
    return out


def spgemm_band(a: Tensor, b: Tensor, a_idx: Tensor, b_idx: Tensor,
                sel: Tensor, wa: int, width: int) -> Tensor:
    """B6: the [n_out = len(sel), bs, bs] tile stack in slot order from
    the band tables (``a_idx`` [gr·wa], ``b_idx`` [gr·wa·width])."""
    global LAUNCHES_BAND
    _check(a, b, (a_idx, b_idx, sel))
    if a_idx.numel() % wa or b_idx.numel() != a_idx.numel() * width:
        raise ValueError(f"band tables of {a_idx.numel()} / {b_idx.numel()} "
                         f"entries do not fit wa={wa}, width={width}")
    if a.device.type == "cpu":
        return spgemm_band_plain(a, b, a_idx, b_idx, sel, wa, width)
    n_out, bs = sel.numel(), a.shape[1]
    out = torch.empty((n_out, bs, bs), dtype=a.dtype, device=a.device)
    chosen, code, a_vec, b_vec, idx, stream = _cuda_args(a, b, out)
    with torch.cuda.device(a.device):
        rc = _library().matrel_spgemm_band(
            a.data_ptr(), b.data_ptr(), out.data_ptr(), sel.data_ptr(),
            a_idx.data_ptr(), b_idx.data_ptr(), n_out, wa, width,
            a.shape[0], b.shape[0], bs, code, a_vec, b_vec, idx, stream)
    tile_body.raise_on(rc, f"spgemm_band ({chosen} body)")
    LAUNCHES_BAND += 1
    BODY_LAUNCHES[chosen] += 1
    return out
