"""Worklist K-column gather, row gather and slice lookups of the weak (APD)
path: kernels H5, H6 and H7.

PyTorch counterpart of ``apdmvs_tpu/ops/cols.py``. The weak machinery
evaluates patch costs at scattered positions: each weak pixel and its 8
anchors, which may lie far apart. Anchors are fixed for a whole pass
(APD.cu:2415), so once a pass the K-column of every cost or depth volume
at every worklist position is gathered (``gather_cols``, H5), and every
lookup inside the iteration loop becomes a dense lookup over those
resident columns (``contract_lookup``, H6): a clamped linear interpolation
along K (tent) or the nearest slice.

The reference package gathers those columns as whole rows of a
position-major table (``pack_volume_rows``); the port reads the volumes in
place through H5 instead, and keeps the table entry points for callers that
hold such a table: ``gather_rows`` and ``gather_rows_sorted`` (H7).

Kernels, each replacing a TPU kernel of ``apdmvs_tpu/ops/cols.py``:

- H5 ``csrc/gather_cols.cu``: ``:50 _make_gather_kernel`` (``gather_rows``,
  ``:90``) with the layout work of ``build_weak_cols`` around it;
- H6 ``csrc/contract_lookup.cu``: ``:335 _contract_kernel``
  (``contract_lookup``, ``:351``);
- H7 ``csrc/gather_rows.cu``: ``:151 _make_sorted_gather_kernel``
  (``gather_rows_sorted``, ``:208``) and the table entry point of ``:50``
  (``gather_rows``, ``:90``).

The plain functions ``pack_volume_rows``, ``flat_index``,
``gather_rows_ref``, ``tent_lookup`` and ``nearest_lookup`` are the
reference package's mirrors; the plain versions of H5 and H6 are composed
of them exactly as the reference package composes them, and
``gather_rows_ref`` is H7's. Each wrapper runs its plain version on CPU
tensors and launches its kernel on CUDA tensors, and counts its launches
in ``<wrapper>.launches``.
"""

from __future__ import annotations

import ctypes

import torch

from apdmvs_tpu_torch.ops import _build


def pack_volume_rows(vol: torch.Tensor) -> torch.Tensor:
    """[Vs, K, PH, PW] source-view volume -> position-major row table
    [PH * PW, Vs * K]."""
    Vs, K, PH, PW = vol.shape
    return vol.permute(2, 3, 0, 1).reshape(PH * PW, Vs * K)


def flat_index(xs, ys, pad_y: int, pad_x: int, PH: int, PW: int) -> torch.Tensor:
    """Row index of unpadded pixel coordinates into the padded position
    grid; coordinates clamp into the grid (so -1 reads position pad-1;
    callers mask such rows)."""
    xi = torch.clamp(xs.to(torch.int64) + pad_x, 0, PW - 1)
    yi = torch.clamp(ys.to(torch.int64) + pad_y, 0, PH - 1)
    return yi * PW + xi


def gather_rows_ref(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """out[m] = table[clip(idx[m])]."""
    return table[torch.clamp(idx.to(torch.int64), 0, table.shape[0] - 1)]


def tent_lookup(cols: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Linear interpolation along the minor K axis as a tent-weight sum:
    out = sum_i cols[..., i] * max(0, 1 - |clip(k) - i|). A NaN ``k`` gives
    NaN."""
    K = cols.shape[-1]
    kc = torch.clamp(k, 0.0, K - 1.0)[..., None]
    ki = torch.arange(K, dtype=torch.float32, device=cols.device)
    w = torch.clamp(1.0 - torch.abs(kc - ki), min=0.0)
    return torch.sum(cols.to(torch.float32) * w, dim=-1)


def nearest_lookup(cols: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Nearest slice along K (round half to even) as a one-hot sum. A NaN
    ``k`` matches no slice and gives 0."""
    K = cols.shape[-1]
    ki = torch.round(torch.clamp(k, 0.0, K - 1.0))[..., None]
    ii = torch.arange(K, dtype=torch.float32, device=cols.device)
    return torch.sum(cols.to(torch.float32) * (ki == ii).to(torch.float32), dim=-1)


# ---------------------------------------------------------------------------
# H5: K-columns of a volume at worklist positions
# ---------------------------------------------------------------------------


def gather_cols_ref(vol, xs, ys, pad_y: int, pad_x: int) -> torch.Tensor:
    """Plain version of H5: out[v, k, m] = vol[v, k, clip(ys[m] + pad_y),
    clip(xs[m] + pad_x)], [Vs, K, M] in vol's dtype (the reference
    package's pack_volume_rows -> flat_index -> gather_rows -> transpose)."""
    Vs, K, PH, PW = vol.shape
    M = xs.shape[0]
    rows = gather_rows_ref(pack_volume_rows(vol), flat_index(xs, ys, pad_y, pad_x, PH, PW))
    return rows.reshape(M, Vs, K).permute(1, 2, 0).contiguous()


_GATHER_SIG = {
    "gather_cols_launch": [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_void_p,
    ]
}


def gather_cols(vol, xs, ys, pad_y: int, pad_x: int) -> torch.Tensor:
    """Kernel H5 wrapper (for the TPU kernel ``_make_gather_kernel``,
    ``gather_rows``): the columns of :func:`gather_cols_ref`, read in place
    from the [Vs, K, PH, PW] volume (bf16 or f32)."""
    if vol.dim() != 4 or vol.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError("vol must be a [Vs, K, PH, PW] bf16 or f32 tensor")
    if xs.dim() != 1 or xs.shape != ys.shape:
        raise ValueError("xs and ys must be matching [M] tensors")
    if len({vol.device, xs.device, ys.device}) != 1:
        raise ValueError("inputs on several devices")
    if vol.device.type == "cpu":
        return gather_cols_ref(vol, xs, ys, pad_y, pad_x)
    if vol.device.type != "cuda":
        raise ValueError(f"unsupported device {vol.device}")
    Vs, K, PH, PW = vol.shape
    M = xs.shape[0]
    vol = vol.contiguous()
    xs = xs.to(torch.int32).contiguous()
    ys = ys.to(torch.int32).contiguous()
    out = torch.empty((Vs, K, M), dtype=vol.dtype, device=vol.device)
    if M == 0:
        return out
    lib = _build.load("gather_cols", _GATHER_SIG)
    with _build.on_device(vol):
        err = lib.gather_cols_launch(
            vol.data_ptr(), xs.data_ptr(), ys.data_ptr(), Vs * K, PH, PW, M, pad_y, pad_x,
            vol.element_size(), out.data_ptr(), torch.cuda.current_stream(vol.device).cuda_stream,
        )
    _build.check(err, "gather_cols")
    gather_cols.launches += 1
    return out


gather_cols.launches = 0


# ---------------------------------------------------------------------------
# H7: whole rows of a position-major table
# ---------------------------------------------------------------------------


_ROWS_SIG = {
    "gather_rows_launch": [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_longlong,
        ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p,
    ]
}


def _gather_rows(table: torch.Tensor, idx: torch.Tensor, wrapper) -> torch.Tensor:
    """Checks, the CPU branch and the H7 launch shared by the two entry
    points; a launch counts on ``wrapper.launches``."""
    if table.dim() != 2:
        raise ValueError("table must be a [R, C] tensor")
    if idx.dim() != 1 or idx.dtype not in (torch.int32, torch.int64):
        raise ValueError("idx must be an [M] int32 or int64 tensor")
    if table.device != idx.device:
        raise ValueError("inputs on several devices")
    if table.device.type == "cpu":
        return gather_rows_ref(table, idx)
    if table.device.type != "cuda":
        raise ValueError(f"unsupported device {table.device}")
    R, C = table.shape
    M = idx.shape[0]
    out = torch.empty((M, C), dtype=table.dtype, device=table.device)
    if M == 0:
        return out
    if R == 0:
        raise ValueError("gather from an empty table")
    table = table.contiguous()
    idx = idx.contiguous()  # int32 or int64 as it comes: the kernel reads either
    lib = _build.load("gather_rows", _ROWS_SIG)
    with _build.on_device(table):
        err = lib.gather_rows_launch(
            table.data_ptr(), idx.data_ptr(), idx.element_size(), R, M, C * table.element_size(),
            out.data_ptr(), torch.cuda.current_stream(table.device).cuda_stream,
        )
    _build.check(err, "gather_rows")
    wrapper.launches += 1
    return out


def gather_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Kernel H7 wrapper for the table entry point of the TPU kernel
    ``_make_gather_kernel`` (``gather_rows``): out[m] = table[clip(idx[m])],
    [M, C] in the table's dtype, a bit-exact copy (:func:`gather_rows_ref`).
    The weak machinery reads its volumes in place through
    :func:`gather_cols` instead; this serves callers that hold a
    position-major table. A table that is not contiguous, such as the view
    :func:`pack_volume_rows` returns, is copied whole before the launch."""
    return _gather_rows(table, idx, gather_rows)


gather_rows.launches = 0


def gather_rows_sorted(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Kernel H7 wrapper for the TPU kernel ``_make_sorted_gather_kernel``
    (``gather_rows_sorted``): :func:`gather_rows` for non-decreasing
    ``idx``. Sortedness is not checked and changes nothing (the reference
    calls it a correctness-neutral invariant): the TPU kernel used it to
    share one DMA between neighbouring requests of one row group, while on
    the card L2 serves repeated rows to the same kernel."""
    return _gather_rows(table, idx, gather_rows_sorted)


gather_rows_sorted.launches = 0


# ---------------------------------------------------------------------------
# H6: tent / nearest lookups of all candidates over resident columns
# ---------------------------------------------------------------------------


def contract_lookup_ref(cols_t, k, nearest: bool = False) -> torch.Tensor:
    """Plain version of H6: out[b, v, r] = tent (or nearest) lookup of
    cols_t[v, :, r] at k[b, r]; [B, Vs, R] f32 (the reference package's
    mirror on the transposed layout, one candidate at a time)."""
    look = nearest_lookup if nearest else tent_lookup
    cols = cols_t.movedim(1, -1)  # [Vs, R, K]
    return torch.stack([look(cols, k[b][None]) for b in range(k.shape[0])])


_CONTRACT_SIG = {
    "contract_lookup_launch": [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
    ]
}


def contract_lookup(cols_t, k, nearest: bool = False) -> torch.Tensor:
    """Kernel H6 wrapper (for the TPU kernel ``_contract_kernel``):
    cols_t [Vs, K, R] bf16 or f32, k [B, R] f32 -> [B, Vs, R] f32, as
    :func:`contract_lookup_ref`, including NaN for a NaN ``k`` (tent)."""
    if cols_t.dim() != 3 or cols_t.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError("cols_t must be a [Vs, K, R] bf16 or f32 tensor")
    if k.dim() != 2 or k.shape[1] != cols_t.shape[2] or k.dtype != torch.float32:
        raise ValueError("k must be a [B, R] float32 tensor")
    if cols_t.device != k.device:
        raise ValueError("inputs on several devices")
    if cols_t.device.type == "cpu":
        return contract_lookup_ref(cols_t, k, nearest)
    if cols_t.device.type != "cuda":
        raise ValueError(f"unsupported device {cols_t.device}")
    Vs, K, R = cols_t.shape
    B = k.shape[0]
    cols_t, k = cols_t.contiguous(), k.contiguous()
    out = torch.empty((B, Vs, R), dtype=torch.float32, device=k.device)
    if R == 0 or B == 0:
        return out
    lib = _build.load("contract_lookup", _CONTRACT_SIG)
    with _build.on_device(k):
        err = lib.contract_lookup_launch(
            cols_t.data_ptr(), k.data_ptr(), Vs, K, R, B, int(nearest),
            int(cols_t.dtype == torch.bfloat16), out.data_ptr(),
            torch.cuda.current_stream(k.device).cuda_stream,
        )
    _build.check(err, "contract_lookup")
    contract_lookup.launches += 1
    return out


contract_lookup.launches = 0
