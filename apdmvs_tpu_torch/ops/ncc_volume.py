"""Volume NCC cost, volume rebase and geometric cost: kernels H2, H3, H4.

PyTorch counterpart of ``apdmvs_tpu/ops/ncc_volume.py``. The reference
package evaluates one function, the exact volume NCC of C candidate plane
fields against one source view, through six TPU kernels that differ only in
how they fetch: the L1 band ``:353 _kernel`` with its L2 fixups (the
two-band ``:708 _band2_kernel`` under ``APDMVS_BAND2=1``, then the full-K
``:625 _fixup_kernel``), the full-K ``:574 _kernel_fullk``, the rebased
``:205 _kernel_rb`` and the auto-centred sweep bands ``:1659
_kernel_rb_offs``. The bands, the fixups and the rebase exist because a TPU
core cannot gather: it streams windows of slices and selects. Here one CUDA
kernel, ``csrc/ncc_cost.cu`` (H2), loads the two slices of every sample of
E by address and serves all four public entry points, so it is also the
counterpart of the L2 chain; :func:`ncc_cost_views` evaluates every source
view in one launch, and the cost harness (``ncc.py``) calls only that. The
rebased volume R (H3, ``csrc/rebase_view.cu``, for ``:1029
_rebase_kernel``) is a copy of part of E: H2 never reads it, and no path of
the port builds it; :func:`build_rebased_view` stays as K4's counterpart.
The geometric-consistency cost over depth volumes is H4
(``csrc/geom_cost.cu``, for ``:1370 _geom_kernel``); like H2 it evaluates
every source view in one launch (:func:`geom_cost_views`), and the cost
harness calls only that.

Layout and padding follow the reference package so arrays compare index for
index: volumes are [K, H+2*PAD_Y, W+2*PAD_X] over the padded pixel grid,
H a multiple of NCC_TILE_H and W of TILE_W; planes are channel-first
[C, 4, H, W]; per-view constants are packed by :func:`pack_consts` /
:func:`pack_geom_consts`.

Each wrapper runs its plain PyTorch version on CPU tensors and launches its
kernel on CUDA tensors, and counts its launches in ``<wrapper>.launches``.
"""

from __future__ import annotations

import ctypes

import torch

from apdmvs_tpu_torch.ops import _build

PAD_Y = 8
PAD_X = 128
TILE_W = 128
NCC_TILE_H = 16
J_REBASE = 12
J2_REBASE = 2 * J_REBASE + 1  # 25: propagation / recost rebase window
SWEEP_J2 = 49  # classify sweep rebase window
COST_MAX = 2.0
GEOM_COST_MAX = 3.0
MIN_VAR = 1e-5

# consts layout [1, 21]: fx, fy, cx, cy, u_min, du, M(9), b(3), src_w, src_h, row0
_NCONST = 21
# geom consts layout [1, 33]: fx, fy, cx, cy, u_min, du, M(9), b(3), A(9),
# t'(3), src_w, src_h, row0
_NGEOM = 33


def _f32(v, device) -> torch.Tensor:
    return torch.as_tensor(v, dtype=torch.float32, device=device).reshape(-1)


def pack_consts(K0, M, b, u_min, du, src_w: int, src_h: int, row0=0.0) -> torch.Tensor:
    dev = K0.device
    return torch.cat([
        torch.stack([K0[0, 0], K0[1, 1], K0[0, 2], K0[1, 2]]).float(),
        _f32(u_min, dev), _f32(du, dev),
        M.reshape(-1).float(), b.reshape(-1).float(),
        _f32([src_w, src_h], dev), _f32(row0, dev),
    ]).reshape(1, _NCONST)


def pack_geom_consts(K0, M, b, A, t2, u_min, du, src_w: int, src_h: int, row0=0.0) -> torch.Tensor:
    """A = K_ref R_ref R_src^T K_src^{-1}; t2 = K_ref R_ref (c_src - c_ref):
    closed-form reprojection of (src pixel, src depth) into the ref view
    (APD.cu:752-789)."""
    dev = K0.device
    return torch.cat([
        torch.stack([K0[0, 0], K0[1, 1], K0[0, 2], K0[1, 2]]).float(),
        _f32(u_min, dev), _f32(du, dev),
        M.reshape(-1).float(), b.reshape(-1).float(),
        A.reshape(-1).float(), t2.reshape(-1).float(),
        _f32([src_w, src_h], dev), _f32(row0, dev),
    ]).reshape(1, _NGEOM)


def fma(a, b, c) -> torch.Tensor:
    """a * b + c of float32 tensors, rounded once as a fused multiply-add
    does (exact in float64, where the product of two float32 is exact)."""
    a, b, c = (torch.as_tensor(x).to(torch.float64) for x in (a, b, c))
    return torch.addcmul(c, a, b).to(torch.float32)


def _offsets(radius: int, increment: int):
    vals = list(range(-radius, radius + 1, increment))
    return [(dx, dy) for dx in vals for dy in vals]


def _slice_index(k: torch.Tensor, K: int) -> torch.Tensor:
    """int64 index of a float slice coordinate; NaN -> 0 (its cost is NaN
    through the interpolation weight either way)."""
    return torch.nan_to_num(k, nan=0.0).to(torch.int64).clamp_(0, K - 1)


def _check_common(E, ref_pad, planes, consts, num_slices: int, views: bool = False):
    """Check the NCC inputs: E [K, PH, PW] and consts [1, 21], or with
    ``views`` E [NV, K, PH, PW] and consts [NV, 1, 21]; K = num_slices."""
    if planes.dim() != 4 or planes.shape[1] != 4 or planes.dtype != torch.float32:
        raise ValueError("planes must be [C, 4, H, W] float32")
    C, _, H, W = planes.shape
    if H % NCC_TILE_H or W % TILE_W:
        raise ValueError(f"planes grid {H}x{W} must be padded to ({NCC_TILE_H}, {TILE_W})")
    PH, PW = H + 2 * PAD_Y, W + 2 * PAD_X
    lead = E.shape[:1] if views else ()
    if E.dim() != 3 + len(lead) or tuple(E.shape[-3:]) != (num_slices, PH, PW):
        raise ValueError(f"E must be [{'NV, ' if views else ''}{num_slices}, {PH}, {PW}], "
                         f"got {tuple(E.shape)}")
    if tuple(ref_pad.shape) != (PH, PW) or ref_pad.dtype != torch.float32:
        raise ValueError("ref_pad must be [PH, PW] float32")
    if tuple(consts.shape) != (*lead, 1, _NCONST) or consts.dtype != torch.float32:
        raise ValueError(f"consts must be [{'NV, ' if views else ''}1, 21] float32")
    devs = {t.device for t in (E, ref_pad, planes, consts)}
    if len(devs) != 1:
        raise ValueError(f"inputs on several devices: {devs}")
    return C, H, W


# ---------------------------------------------------------------------------
# H2: exact volume NCC
# ---------------------------------------------------------------------------


def ncc_moments(s_rr, s_ss, s_rs, mr, ms, inv):
    """(var_r, var_s, cov) of the window sums, each s * inv - m * m' as one
    fused multiply-add, as the reference computes them (the JAX package's
    compiled code; nvcc's default contraction in the CUDA reference). It
    decides constant patches: separately rounded, their variance is exactly
    0 < MIN_VAR and the patch is degenerate; fused, it is the rounding
    error of 1/S times the squared mean (~2e-4 at grey 128), the patch
    costs ~1 and a textureless region is classified WEAK, not UNKNOWN."""
    return fma(s_rr, inv, -(mr * mr)), fma(s_ss, inv, -(ms * ms)), fma(s_rs, inv, -(mr * ms))


def ncc_volume_cost_ref(E_pad, ref_pad, planes, consts, num_slices: int,
                        radius: int = 5, increment: int = 2) -> torch.Tensor:
    """Plain version of H2 (the reference package's
    ``ncc_volume_cost_view_ref``): [C, H, W] f32 costs, full-range
    interpolation along K, same operation order as the kernel."""
    C, _, H, W = planes.shape
    K = E_pad.shape[0]
    dev = planes.device
    c = consts[0]
    fx, fy, cx, cy, u_min, du = (c[m] for m in range(6))
    M = c[6:15].reshape(3, 3)
    b = c[15:18]
    src_w, src_h, row0 = c[18], c[19], c[20]
    ys, xs = torch.meshgrid(
        torch.arange(H, dtype=torch.float32, device=dev),
        torch.arange(W, dtype=torch.float32, device=dev), indexing="ij",
    )
    ys = ys + row0
    n = planes[:, :3]
    w = planes[:, 3]
    z = torch.zeros((H, W), dtype=torch.float32, device=dev)
    zc = torch.zeros((C, H, W), dtype=torch.float32, device=dev)
    s_r, s_rr, s_s, s_ss, s_rs = z, z, zc, zc, zc
    offsets = _offsets(radius, increment)
    E32 = E_pad.to(torch.float32)  # widened once: bf16 -> f32 is exact
    for dx, dy in offsets:
        dirx = (xs + float(dx) - cx) / fx
        diry = (ys + float(dy) - cy) / fy
        u = -(n[:, 0] * dirx + n[:, 1] * diry + n[:, 2]) / w
        k = torch.clamp((u - u_min) / du, 0.0, num_slices - 1.0)
        E_sh = E32[:, PAD_Y + dy: PAD_Y + dy + H, PAD_X + dx: PAD_X + dx + W]
        k0 = _slice_index(torch.floor(k), K)
        k1 = torch.clamp(k0 + 1, max=K - 1)
        f = k - k0.to(torch.float32)
        e0 = torch.gather(E_sh, 0, k0)
        e1 = torch.gather(E_sh, 0, k1)
        sv = e0 * (1.0 - f) + e1 * f
        rv = ref_pad[PAD_Y + dy: PAD_Y + dy + H, PAD_X + dx: PAD_X + dx + W]
        s_r, s_rr = s_r + rv, s_rr + rv * rv
        s_s, s_ss, s_rs = s_s + sv, s_ss + sv * sv, s_rs + rv * sv
    inv = torch.tensor(1.0 / float(len(offsets)), dtype=torch.float32, device=dev)
    mr, ms = s_r * inv, s_s * inv
    var_r, var_s, cov = ncc_moments(s_rr, s_ss, s_rs, mr, ms, inv)
    cost = torch.clamp(1.0 - cov * torch.rsqrt(torch.clamp(var_r * var_s, min=1e-30)),
                       0.0, COST_MAX)
    cost = torch.where((var_r < MIN_VAR) | (var_s < MIN_VAR), COST_MAX, cost)
    dirx = (xs - cx) / fx
    diry = (ys - cy) / fy
    u_c = -(n[:, 0] * dirx + n[:, 1] * diry + n[:, 2]) / w
    qx = M[0, 0] * dirx + M[0, 1] * diry + M[0, 2] + b[0] * u_c
    qy = M[1, 0] * dirx + M[1, 1] * diry + M[1, 2] + b[1] * u_c
    qz = M[2, 0] * dirx + M[2, 1] * diry + M[2, 2] + b[2] * u_c
    oob = (qx / qz < 0) | (qx / qz >= src_w) | (qy / qz < 0) | (qy / qz >= src_h)
    return torch.where(oob, COST_MAX, cost)


_NCC_SIG = {
    "ncc_cost_launch": [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
    ]
}
# H2 unrolls its window: 1 to 8 samples a side (radius 5 step 2 gives 6)
MAX_WINDOW_SIDE = 8


def _launch_ncc(E, ref_pad, planes, consts, num_slices: int, radius: int,
                increment: int) -> torch.Tensor:
    """One H2 launch: E [NV, K, PH, PW] bf16, consts [NV, 1, 21] on a CUDA
    card -> costs [NV, C, H, W]. The caller has checked the shapes."""
    if E.device.type != "cuda":
        raise ValueError(f"unsupported device {E.device}")
    if E.dtype != torch.bfloat16:
        raise ValueError("the CUDA NCC kernel reads a bf16 volume")
    NV, K, PH, PW = E.shape
    if increment < 1 or not 0 <= radius <= PAD_Y:
        raise ValueError(f"bad NCC window radius={radius} increment={increment}")
    if len(range(-radius, radius + 1, increment)) > MAX_WINDOW_SIDE:
        raise ValueError(f"the CUDA NCC kernel takes at most {MAX_WINDOW_SIDE} samples a side")
    if K * PH * PW >= 2 ** 31:
        raise ValueError("one view of E exceeds 32-bit indexing")
    C, _, H, W = planes.shape
    E, ref_pad = E.contiguous(), ref_pad.contiguous()
    planes, consts = planes.contiguous(), consts.contiguous()
    out = torch.empty((NV, C, H, W), dtype=torch.float32, device=E.device)
    lib = _build.load("ncc_cost", _NCC_SIG)
    err = lib.ncc_cost_launch(
        E.data_ptr(), ref_pad.data_ptr(), planes.data_ptr(), consts.data_ptr(),
        NV, C, H, W, num_slices, radius, increment,
        out.data_ptr(), torch.cuda.current_stream(E.device).cuda_stream,
    )
    _build.check(err, "ncc_cost")
    return out


def ncc_cost(E_pad, ref_pad, planes, consts, num_slices: int, radius: int = 5,
             increment: int = 2) -> torch.Tensor:
    """Kernel H2 wrapper, one source view: exact NCC costs [C, H, W] from
    E_pad [K, PH, PW] and consts [1, 21]."""
    _check_common(E_pad, ref_pad, planes, consts, num_slices)
    if E_pad.device.type == "cpu":
        return ncc_volume_cost_ref(E_pad, ref_pad, planes, consts, num_slices,
                                   radius=radius, increment=increment)
    out = _launch_ncc(E_pad[None], ref_pad, planes, consts[None], num_slices, radius, increment)
    ncc_cost.launches += 1
    return out[0]


ncc_cost.launches = 0


def ncc_cost_views(E, ref_pad, planes, consts, num_slices: int, radius: int = 5,
                   increment: int = 2) -> torch.Tensor:
    """Kernel H2 wrapper, every source view in one launch: E [NV, K, PH, PW]
    bf16, consts [NV, 1, 21] -> exact NCC costs [NV, C, H, W]. Its plain
    version is :func:`ncc_volume_cost_ref` of each view."""
    _check_common(E, ref_pad, planes, consts, num_slices, views=True)
    if E.device.type == "cpu":
        return torch.stack([
            ncc_volume_cost_ref(E[v], ref_pad, planes, consts[v], num_slices,
                                radius=radius, increment=increment)
            for v in range(E.shape[0])
        ])
    out = _launch_ncc(E, ref_pad, planes, consts, num_slices, radius, increment)
    ncc_cost_views.launches += 1
    return out


ncc_cost_views.launches = 0


def ncc_volume_cost_view(E_pad, ref_pad, planes, consts, num_slices: int,
                         radius: int = 5, increment: int = 2) -> torch.Tensor:
    """Exact NCC costs [C, H, W] from E (the reference package's banded
    kernel + fixup entry).

    In the reference, L1 (``_kernel``) computes the tiles whose samples fit
    its 32-slice band and marks the others with a -1 sentinel; L2 recomputes
    those. With ``APDMVS_BAND2=1``, L2a (``_band2_kernel``, K10) first tries
    two 32-slice windows anchored at the candidate group's k range (a depth
    edge's two sides), bit-exact with the full-K path where they reach, and
    escalates what they miss to L2b, the full-K ``_fixup_kernel``. The chain
    returns the exact NCC of ``ncc_volume_cost_view_ref`` whichever way it
    goes. H2 loads each sample's two slices by address, so no sample can
    miss and there is nothing to fix up: H2 is the counterpart of L1, L2a
    and L2b together. The flag only chooses which TPU kernels compute the
    same values, so the port does not read it."""
    return ncc_cost(E_pad, ref_pad, planes, consts, num_slices, radius, increment)


def ncc_volume_cost_view_fullk(E_pad, ref_pad, planes, consts, num_slices: int,
                               radius: int = 5, increment: int = 2) -> torch.Tensor:
    """Exact NCC costs for structurally unbounded hypotheses (the random
    refinement combos). Same kernel: there is no band to escape here."""
    return ncc_cost(E_pad, ref_pad, planes, consts, num_slices, radius, increment)


def ncc_rebased_cost_view(R_pad, bf_pad, E_pad, ref_pad, planes, consts,
                          num_slices: int, radius: int = 5, increment: int = 2):
    """Exact NCC costs of the reference package's rebased entry (propagation,
    combos 3-4, recost), with its signature. ``R_pad`` and ``bf_pad`` (from
    :func:`build_rebased_view`) are not read: R is a copy of part of E, and
    H2 computes the same costs from E alone."""
    return ncc_cost(E_pad, ref_pad, planes, consts, num_slices, radius, increment)


def ncc_rebased_sweep_cost_view(R_pad, bf_pad, E_pad, ref_pad, planes, consts,
                                num_slices: int, radius: int = 5, increment: int = 2):
    """Exact NCC costs of a classify sweep chunk (the reference package's
    entry through the volume rebased on the chunk's mid step), with its
    signature; like :func:`ncc_rebased_cost_view`, computed from E alone."""
    return ncc_cost(E_pad, ref_pad, planes, consts, num_slices, radius, increment)


# ---------------------------------------------------------------------------
# H3: rebased volumes R[j, p] = E[b(p) + j - J, p]
# ---------------------------------------------------------------------------


def build_rebased_view_ref(E_pad, base_k, num_slices: int, j2: int = J2_REBASE):
    """Plain version of H3 (the reference package's CPU branch of
    ``build_rebased_view``): returns (R [j2, PH, PW] in E's dtype, bf [PH, PW]
    f32). Round half to even (torch.round), then clip."""
    J = (j2 - 1) // 2
    b = torch.clamp(torch.round(base_k), J, num_slices - 1 - J)
    bi = b.to(torch.int64)
    R = torch.stack([
        torch.gather(E_pad, 0, (bi + (j - J))[None])[0] for j in range(j2)
    ]).to(E_pad.dtype)
    return R, b.to(torch.float32)


_REBASE_SIG = {
    "rebase_view_launch": [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ]
}


def rebase_vector_path(num_positions: int, *addresses: int) -> bool:
    """Whether H3 copies 16 bytes at a time: every slice row of E and R
    (``num_positions`` bf16 elements each), base_k and bf must start on a
    16-byte boundary, so the count must be a multiple of 8 and every base
    address 16-byte aligned. Otherwise it copies element by element."""
    return num_positions % 8 == 0 and all(a % 16 == 0 for a in addresses)


def build_rebased_view(E_pad, base_k, num_slices: int, j2: int = J2_REBASE):
    """Kernel H3 wrapper (for the TPU kernel ``_rebase_kernel``)."""
    K, PH, PW = E_pad.shape
    if K != num_slices or j2 > K or j2 % 2 != 1:
        raise ValueError(f"bad rebase window j2={j2} for K={K}")
    if tuple(base_k.shape) != (PH, PW) or base_k.dtype != torch.float32:
        raise ValueError("base_k must be f32 [PH, PW]")
    if base_k.device != E_pad.device:
        raise ValueError("E_pad and base_k on different devices")
    if E_pad.device.type == "cpu":
        return build_rebased_view_ref(E_pad, base_k, num_slices, j2)
    if E_pad.device.type != "cuda":
        raise ValueError(f"unsupported device {E_pad.device}")
    if E_pad.dtype != torch.bfloat16:
        raise ValueError("the CUDA rebase kernel copies a bf16 volume")
    P = PH * PW
    if P >= 2 ** 31:
        raise ValueError(f"{PH}x{PW} positions exceed the kernel's 32-bit offsets in a slice")
    E_pad, base_k = E_pad.contiguous(), base_k.contiguous()
    R = torch.empty((j2, PH, PW), dtype=E_pad.dtype, device=E_pad.device)
    bf = torch.empty((PH, PW), dtype=torch.float32, device=E_pad.device)
    ptrs = (E_pad.data_ptr(), base_k.data_ptr(), R.data_ptr(), bf.data_ptr())
    lib = _build.load("rebase_view", _REBASE_SIG)
    err = lib.rebase_view_launch(
        ptrs[0], ptrs[1], K, P, j2, int(rebase_vector_path(P, *ptrs)), ptrs[2], ptrs[3],
        torch.cuda.current_stream(E_pad.device).cuda_stream,
    )
    _build.check(err, "rebase_view")
    build_rebased_view.launches += 1
    return R, bf


build_rebased_view.launches = 0


# ---------------------------------------------------------------------------
# H4: geometric-consistency cost over depth volumes
# ---------------------------------------------------------------------------


def geom_volume_cost_view_ref(D, planes, consts, num_slices: int) -> torch.Tensor:
    """Plain version of H4 (the reference package's
    ``geom_volume_cost_view_ref``): exact nearest-slice lookup."""
    C, _, H, W = planes.shape
    dev = planes.device
    c = consts[0]
    fx, fy, cx, cy, u_min, du = (c[m] for m in range(6))
    M = c[6:15].reshape(3, 3)
    b = c[15:18]
    A = c[18:27].reshape(3, 3)
    t2 = c[27:30]
    src_w, src_h = c[30], c[31]
    ys, xs = torch.meshgrid(
        torch.arange(H, dtype=torch.float32, device=dev),
        torch.arange(W, dtype=torch.float32, device=dev), indexing="ij",
    )
    ys = ys + c[32]
    dirx = (xs - cx) / fx
    diry = (ys - cy) / fy
    out = []
    for ci in range(C):
        n = planes[ci]
        u = -(n[0] * dirx + n[1] * diry + n[2]) / n[3]
        k = torch.clamp((u - u_min) / du, 0.0, num_slices - 1.0)
        ri = _slice_index(torch.round(k), D.shape[0])
        sd = torch.gather(D, 0, ri[None])[0].to(torch.float32)
        qx = M[0, 0] * dirx + M[0, 1] * diry + M[0, 2] + b[0] * u
        qy = M[1, 0] * dirx + M[1, 1] * diry + M[1, 2] + b[1] * u
        qz = M[2, 0] * dirx + M[2, 1] * diry + M[2, 2] + b[2] * u
        px = qx / qz
        py = qy / qz
        oob = (px < 0.0) | (px >= src_w) | (py < 0.0) | (py >= src_h)
        rx_ = A[0, 0] * px + A[0, 1] * py + A[0, 2]
        ry_ = A[1, 0] * px + A[1, 1] * py + A[1, 2]
        rz_ = A[2, 0] * px + A[2, 1] * py + A[2, 2]
        bx = (sd * rx_ + t2[0]) / (sd * rz_ + t2[2])
        by = (sd * ry_ + t2[1]) / (sd * rz_ + t2[2])
        ex, ey = xs - bx, ys - by
        err = torch.sqrt(ex * ex + ey * ey)
        cost = torch.minimum(err, torch.tensor(GEOM_COST_MAX, device=dev))
        out.append(torch.where((sd == 0.0) | oob, GEOM_COST_MAX, cost))
    return torch.stack(out)


_GEOM_SIG = {
    "geom_cost_launch": [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
    ]
}
# H4 stages every view's constants in one block's shared memory (144 bytes a view)
MAX_GEOM_VIEWS = 256


def _check_geom(D, planes, consts, num_slices: int, views: bool = False):
    """Check the geometric-cost inputs: D [K, H, W] and consts [1, 33], or
    with ``views`` D [NV, K, H, W] and consts [NV, 1, 33]; K = num_slices."""
    if planes.dim() != 4 or planes.shape[1] != 4 or planes.dtype != torch.float32:
        raise ValueError("planes must be [C, 4, H, W] float32")
    _, _, H, W = planes.shape
    lead = D.shape[:1] if views else ()
    if (D.dim() != 3 + len(lead) or tuple(D.shape[-3:]) != (num_slices, H, W)
            or D.dtype != torch.float32):
        raise ValueError(f"D must be f32 [{'NV, ' if views else ''}{num_slices}, {H}, {W}], "
                         f"got {tuple(D.shape)}")
    if tuple(consts.shape) != (*lead, 1, _NGEOM) or consts.dtype != torch.float32:
        raise ValueError(f"geom consts must be [{'NV, ' if views else ''}1, 33] float32")
    if len({D.device, planes.device, consts.device}) != 1:
        raise ValueError("inputs on several devices")


def geom_offsets_fit(num_slices: int, C: int, H: int, W: int) -> bool:
    """Whether H4 can address these shapes: each view's D and costs start at
    a 64-bit base, and the offsets inside a view (slice and pixel into D,
    plane and pixel into the planes and the costs) are 32-bit, so one
    view's D (K * H * W) and the planes (4C * H * W) must stay under 2^32
    elements; the number of views does not count."""
    return max(num_slices, 4 * C) * H * W < 2 ** 32


def _launch_geom(D, planes, consts, num_slices: int) -> torch.Tensor:
    """One H4 launch: D [NV, K, H, W], consts [NV, 1, 33] on a CUDA card ->
    costs [NV, C, H, W]. The caller has checked the shapes."""
    if D.device.type != "cuda":
        raise ValueError(f"unsupported device {D.device}")
    NV = D.shape[0]
    C, _, H, W = planes.shape
    if not 1 <= NV <= MAX_GEOM_VIEWS:
        raise ValueError(f"the CUDA geometric kernel takes 1 to {MAX_GEOM_VIEWS} views")
    if not geom_offsets_fit(num_slices, C, H, W):
        raise ValueError("one view's D, or the planes, exceed the kernel's 32-bit offsets")
    D, planes, consts = D.contiguous(), planes.contiguous(), consts.contiguous()
    out = torch.empty((NV, C, H, W), dtype=torch.float32, device=D.device)
    lib = _build.load("geom_cost", _GEOM_SIG)
    err = lib.geom_cost_launch(
        D.data_ptr(), planes.data_ptr(), consts.data_ptr(), NV, C, H, W, num_slices,
        out.data_ptr(), torch.cuda.current_stream(D.device).cuda_stream,
    )
    _build.check(err, "geom_cost")
    return out


def geom_cost_views(D, planes, consts, num_slices: int) -> torch.Tensor:
    """Kernel H4 wrapper, every source view in one launch: D [NV, K, H, W]
    f32 (``VolumeSet.D`` as it is), consts [NV, 1, 33] -> geometric costs
    [NV, C, H, W]. Its plain version is :func:`geom_volume_cost_view_ref`
    of each view."""
    _check_geom(D, planes, consts, num_slices, views=True)
    if D.device.type == "cpu":
        return torch.stack([geom_volume_cost_view_ref(D[v], planes, consts[v], num_slices)
                            for v in range(D.shape[0])])
    out = _launch_geom(D, planes, consts, num_slices)
    geom_cost_views.launches += 1
    return out


geom_cost_views.launches = 0


def geom_volume_cost_view(D, planes, consts, num_slices: int) -> torch.Tensor:
    """Kernel H4 wrapper, one source view (the entry of the TPU kernel
    ``_geom_kernel``): geometric costs [C, H, W] from a source view's depth
    volume D [K, H, W] and consts [1, 33]; the kernel of
    :func:`geom_cost_views` with one view."""
    _check_geom(D, planes, consts, num_slices)
    if D.device.type == "cpu":
        return geom_volume_cost_view_ref(D, planes, consts, num_slices)
    out = _launch_geom(D[None], planes, consts[None], num_slices)
    geom_volume_cost_view.launches += 1
    return out[0]


geom_volume_cost_view.launches = 0
