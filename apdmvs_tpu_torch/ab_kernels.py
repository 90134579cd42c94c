"""Device times of the port's kernels H1-H9 found under ROOT.

    python apdmvs_tpu_torch/ab_kernels.py ROOT [GROUP ...]

GROUP is any of h1, h2, h3, h4, h5, h6, h7, h8, h9 (default: all of them).

Imports ``apdmvs_tpu_torch`` from ROOT (a checkout, or a commit unpacked
with ``git archive``), builds its kernels and times, on the card, in device
time (20 calls captured in one CUDA graph, replayed between two events,
after a warm-up), at the main path's shapes (640x480, 5 views, K=160, the
plane fields of ``chip_smoke.py`` phase 2):

- H1 ``build_volume``: E (bilinear bf16, [160, 496, 896]) and D (trunc f32);
- H2 from E, one source view: C=9 propagation, C=3 random depths, C=8 a
  sweep chunk, C=1;
- H2 through a rebased volume R (the rebase excluded), where the package
  still takes one: C=9 with j2=25 and C=8 with j2=49;
- H2 over the four source views at C=9: one ``ncc_cost_views`` launch where
  the package has it, else four one-view calls;
- H3 ``rebase_view`` at j2=25 and 49 on that E around view 0's ground
  truth (``ncc._base_slice_map``), each first held bit-exact against its
  plain version, beside ``torch.gather`` with the same index tensor;
- H4 at C=8 (the sweep chunk's planes) over the trunc depth volumes: one
  view, and the four source views: one ``geom_cost_views`` launch where the
  package has it, else four one-view calls and the ``torch.stack`` the
  cost harness made of them;
- H7 on the three tables of ``chip_smoke.py``'s ``ops`` phase with its
  index sets (bench.py's flagship worklist: C36's rows at the weak pixels
  sorted, C9's at their anchors, D's at the weak pixels), the sorted case
  also with int32 indices, and ``torch.index_select`` on each as the
  library yardstick;
- H5 ``gather_cols`` on the flagship's volumes at its worklist: C36 and D
  at the weak pixels (24576 slots), C9 at their anchors (196608 slots),
  each beside ``vol[:, :, ys, xs]`` (the same copy as one indexing call);
- H8 ``volume_sample`` on E (bf16) and D (f32, view 1) at the slices of
  view 0's ground truth, each first held bit-exact against its plain
  version, beside one trilinear 5-D ``F.grid_sample`` over the volume in
  f32, and on their first 128 pixels (one block: the launch floor);
- H6 ``contract_lookup``, each case first held against its plain version
  (tent within 1.2e-7 with the same NaN lanes, nearest bit-exact): on the
  first call of each kind (table, B) of one flagship pass, captured with
  its inputs (``H6_pass_*``, ``trace_pass.flagship_h6_calls``); on the
  columns H5 gives at the flagship worklist, at the lookup slices of the
  weak sweep's candidates (``trace_pass.weak_lookups``), B=10 and 5: C36
  and C9 tent, D nearest; and C9 tent with k in a 4-slice band and over all
  of K (``H6_c9_tent_band_B10``, ``H6_c9_tent_spread_B10``). Each nearest
  case also beside ``torch.gather`` along K;
- H9 ``build_cost_volumes`` at the DTU cell's shape (C36 and C9 of 4
  source views x 160 slices of a 1600x1200 set, E [4, 160, 1216, 1920] of
  seeded random grey levels), where the package has it, beside the plain
  build the scene runner ran before it (``build_cost_volume`` of each view
  and window, each copied into its stack), timed with CUDA events around
  one build.

It prints one line ``ABK ROOT {json}`` of milliseconds, and the card's name
and power limit. To compare two commits on one card, run it in fresh
processes, parent, change, change, parent.
"""

import json
import os
import subprocess
import sys


def graph_ms(fn, reps: int = 20) -> float:
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    del graph
    return start.elapsed_time(end) / reps


GROUPS = ("h1", "h2", "h3", "h4", "h5", "h6", "h7", "h8", "h9")


def _helpers(root: str):
    """``trace_pass`` of the package under ROOT, which builds the flagship
    state and the H6 inputs; for a package whose ``trace_pass`` predates
    ``weak_lookups`` and ``flagship_h6_calls``, the ``trace_pass`` beside
    this script, run on the package under ROOT."""
    from apdmvs_tpu_torch import trace_pass

    if hasattr(trace_pass, "flagship_h6_calls"):
        return trace_pass
    import importlib.util

    here = os.path.join(os.path.dirname(os.path.abspath(__file__)), "trace_pass.py")
    spec = importlib.util.spec_from_file_location("_ab_trace_pass", here)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main(root: str, groups=GROUPS) -> None:
    root = os.path.abspath(root)
    sys.path.insert(0, root)
    import inspect

    import numpy as np
    import torch

    from apdmvs_tpu_torch import geometry, ncc
    from apdmvs_tpu_torch.datasets import synthetic
    from apdmvs_tpu_torch.ops import _build, ncc_volume as nv, volume as vol

    if not _build.__file__.startswith(root):
        raise RuntimeError(f"imported {_build.__file__}, not the package under {root}")
    _build.build_all()
    dev = torch.device("cuda", 0)
    W, H, V, K = 640, 480, 5, 160
    cams_s, planes_s = synthetic.make_ring_scene(num_views=V, width=W, height=H)
    images, depths, normals = synthetic.render_scene(cams_s, planes_s)
    cams = geometry.make_cameras(
        np.stack([c.K for c in cams_s]), np.stack([c.R for c in cams_s]),
        np.stack([c.t for c in cams_s]), np.full(V, 1.2), np.full(V, 9.6), device=dev)
    imgs = torch.as_tensor(images, device=dev)
    dm = torch.as_tensor(depths, device=dev)
    wc = geometry.warp_constants(cams)
    # on the card, so that a CUDA graph can capture the wrappers' packing
    u_min, du = (v.to(dev) for v in vol.inv_depth_grid(1.2, 9.6, K))
    Hp, Wp = ncc._ceil_to(H, nv.NCC_TILE_H), ncc._ceil_to(W, nv.TILE_W)
    times = {}

    def build_e(v):
        return vol.build_volume(imgs[v], wc.M[v], wc.b[v], cams.K[0], Hp, Wp, u_min, du, K,
                                pad_y=nv.PAD_Y, pad_x=nv.PAD_X)

    if "h1" in groups:
        times["H1_E"] = graph_ms(lambda: build_e(1))
        times["H1_D"] = graph_ms(lambda: vol.build_volume(
            dm[1], wc.M[1], wc.b[1], cams.K[0], Hp, Wp, u_min, du, K, pad_y=0, pad_x=0,
            dtype=torch.float32, trunc=True))

    Es = torch.stack([build_e(v) for v in range(1, V)])
    E = Es[0]
    consts_v = torch.stack([nv.pack_consts(cams.K[0], wc.M[v], wc.b[v], u_min, du, W, H)
                            for v in range(1, V)])
    consts = consts_v[0]
    ref_pad = ncc._edge_pad(imgs[0], nv.PAD_Y, nv.PAD_Y + Hp - H, nv.PAD_X, nv.PAD_X + Wp - W)
    vs = ncc.VolumeSet(E=E[None], consts=consts[None], ref_pad=ref_pad)

    x, y = geometry.pixel_grid(H, W, dev)
    n_cam = geometry.normal_world_to_cam(cams.R[0], torch.as_tensor(normals[0], device=dev))
    gt = torch.where(dm[0] > 0, dm[0], torch.full_like(dm[0], 4.0))

    def plane_field(depth, normal):
        w = geometry.dist_to_origin(cams.K[0], x, y, depth, normal)
        return torch.cat([normal, w[..., None]], -1)

    def noisy(scale, seed):
        r = np.random.RandomState(seed)
        d = gt * torch.as_tensor(1 + scale * r.randn(H, W), device=dev, dtype=torch.float32)
        n = n_cam + torch.as_tensor(0.05 * r.randn(H, W, 3), device=dev, dtype=torch.float32)
        return plane_field(d, n / torch.linalg.vector_norm(n, dim=-1, keepdim=True))

    rand_depth = torch.as_tensor(np.random.RandomState(0).uniform(1.2, 9.6, (3, H, W)),
                                 device=dev, dtype=torch.float32)
    cases = {
        "C9": torch.stack([noisy(0.01, s) for s in range(9)]),
        "C3_random": torch.stack([plane_field(rand_depth[i], n_cam) for i in range(3)]),
        "C8_sweep": torch.stack([plane_field(gt * (1 + 0.004 * (s - 4)), n_cam)
                                 for s in range(8)]),
        "C1": noisy(0.01, 9)[None],
    }
    cases = {name: ncc._pad_planes_cf(pl, Hp, Wp) for name, pl in cases.items()}
    if "h2" in groups:
        for name, pcf in cases.items():
            times[f"H2_{name}_E"] = graph_ms(lambda: nv.ncc_cost(E, ref_pad, pcf, consts, K))

        if "R_pad" in inspect.signature(nv.ncc_cost).parameters:
            base = ncc._base_slice_map(vs, gt)
            for name, j2 in (("C9", nv.J2_REBASE), ("C8_sweep", nv.SWEEP_J2)):
                R, bf = nv.build_rebased_view(E, base, K, j2=j2)
                pcf = cases[name]
                times[f"H2_{name}_R{j2}"] = graph_ms(
                    lambda: nv.ncc_cost(E, ref_pad, pcf, consts, K, R_pad=R, bf_pad=bf))

        pcf = cases["C9"]
        if hasattr(nv, "ncc_cost_views"):
            times["H2_C9_4views"] = graph_ms(
                lambda: nv.ncc_cost_views(Es, ref_pad, pcf, consts_v, K))
        else:
            times["H2_C9_4views"] = graph_ms(
                lambda: [nv.ncc_cost(Es[v], ref_pad, pcf, consts_v[v], K) for v in range(V - 1)])

    if "h4" in groups:
        # H4: the trunc depth volumes of the four source views, C=8
        vs_d = ncc.add_depth_volumes(vs, dm, cams, 1.2, 9.6)
        Ds, gconsts = vs_d.D, vs_d.geom_consts
        pcf = cases["C8_sweep"]
        times["H4_C8_1view"] = graph_ms(
            lambda: nv.geom_volume_cost_view(Ds[0], pcf, gconsts[0], K))
        if hasattr(nv, "geom_cost_views"):
            times["H4_C8_4views"] = graph_ms(lambda: nv.geom_cost_views(Ds, pcf, gconsts, K))
        else:
            times["H4_C8_4views"] = graph_ms(lambda: torch.stack([
                nv.geom_volume_cost_view(Ds[v], pcf, gconsts[v], K) for v in range(V - 1)]))
        del vs_d, Ds
    if "h3" in groups:
        # H3 around view 0's ground truth (chip_smoke.py phase 2's base map),
        # beside torch.gather with the same index tensor; each j2 first held
        # against the plain version
        base_k = ncc._base_slice_map(vs, dm[0])
        for j2 in (nv.J2_REBASE, nv.SWEEP_J2):
            R, bf = nv.build_rebased_view(E, base_k, K, j2=j2)
            R_ref, bf_ref = nv.build_rebased_view_ref(E, base_k, K, j2=j2)
            if not (torch.equal(R.view(torch.int16), R_ref.view(torch.int16))
                    and torch.equal(bf, bf_ref)):
                raise AssertionError(f"H3 under {root} disagrees with its plain version")
            del R, bf, R_ref, bf_ref
            J = (j2 - 1) // 2
            idx = (torch.clamp(torch.round(base_k), J, K - 1 - J).long()[None]
                   + torch.arange(j2, device=dev)[:, None, None] - J)
            times[f"H3_j2_{j2}"] = graph_ms(lambda: nv.build_rebased_view(E, base_k, K, j2=j2))
            times[f"gather_j2_{j2}"] = graph_ms(lambda: torch.gather(E, 0, idx))
            del idx

    if "h8" in groups:
        # H8 on E (bf16) and D (f32) at view 0's ground truth (chip_smoke.py's
        # ops phase), each first held against the plain version, beside one
        # trilinear 5-D grid_sample over the volume in f32
        import torch.nn.functional as F

        Ds = ncc.add_depth_volumes(vs, dm, cams, 1.2, 9.6).D
        k_E = vol.depth_to_slice(ncc._edge_pad(gt, nv.PAD_Y, nv.PAD_Y + Hp - H, nv.PAD_X,
                                               nv.PAD_X + Wp - W), u_min, du).contiguous()
        for name, Ev, kk in (("E", E, k_E), ("D", Ds[0], vol.depth_to_slice(gt, u_min, du))):
            out, ref = vol.volume_sample(Ev, kk), vol.volume_sample_ref(Ev, kk)
            if not torch.equal(out.view(torch.int32), ref.view(torch.int32)):
                raise AssertionError(f"H8 under {root} disagrees with its plain version ({name})")
            Kv, Hv, Wv = Ev.shape
            Ef = Ev.float()[None, None]
            gy, gx = torch.meshgrid(torch.arange(Hv, device=dev, dtype=torch.float32),
                                    torch.arange(Wv, device=dev, dtype=torch.float32),
                                    indexing="ij")
            grid = torch.stack([gx / (Wv - 1) * 2 - 1, gy / (Hv - 1) * 2 - 1,
                                kk / (Kv - 1) * 2 - 1], -1)[None, None]
            times[f"H8_{name}"] = graph_ms(lambda: vol.volume_sample(Ev, kk))
            # the same kernel on the first 128 pixels: one block, so its time
            # is the graph's launch floor and one k -> E -> store chain
            e1, k1 = Ev[:, :1, :128].contiguous(), kk[:1, :128].contiguous()
            times[f"H8_{name}_128px"] = graph_ms(lambda: vol.volume_sample(e1, k1))
            times[f"grid_sample_{name}"] = graph_ms(lambda: F.grid_sample(
                Ef, grid, mode="bilinear", padding_mode="border", align_corners=True))
            del Ef, grid
        del Ds
    del Es, vs

    if {"h5", "h6", "h7"} & set(groups):
        from apdmvs_tpu_torch.ops import cols

        tp = _helpers(root)
        vsf, prior, cap, _ = tp.flagship_state(images, depths, normals, cams, K)
        weak_xy, a, wcols, k_c, k_a = tp.weak_lookups(cams, vsf, prior, cap, K)
        PH, PW = Hp + 2 * nv.PAD_Y, Wp + 2 * nv.PAD_X
        wx, wy = weak_xy[:, 0], weak_xy[:, 1]
        ax, ay = a[..., 0].reshape(-1), a[..., 1].reshape(-1)

    if "h5" in groups:
        # H5: C36 and D at the weak pixels, C9 at the anchors; the same copy as
        # one indexing call on the clamped coordinates
        for name, (volm, xs, ys, py, px) in {
                "c36": (vsf.C36, wx, wy, nv.PAD_Y, nv.PAD_X),
                "c9_anchors": (vsf.C9, ax, ay, nv.PAD_Y, nv.PAD_X),
                "d": (vsf.D, wx, wy, 0, 0)}.items():
            yi = torch.clamp(ys + py, 0, volm.shape[2] - 1)
            xi = torch.clamp(xs + px, 0, volm.shape[3] - 1)
            times[f"H5_{name}"] = graph_ms(lambda: cols.gather_cols(volm, xs, ys, py, px))
            times[f"index_{name}"] = graph_ms(lambda: volm[:, :, yi, xi])

    if "h6" in groups:
        # H6, each case first held against its plain version: the lookups of
        # a real flagship pass (the first call of each kind); the weak
        # sweep's lookups of weak_lookups over the resident columns, B=10
        # and 5; and C9 tent with k in a 4-slice band and over all of K
        gen = torch.Generator(device=dev)
        gen.manual_seed(2)
        R9 = wcols.c9.shape[2]
        h6 = {f"pass_{kind}": call for kind, call in
              sorted(tp.flagship_h6_calls(cams, vsf, prior, cap, 1).items())}
        for name, table, kk, nearest in (("c36_tent", wcols.c36, k_c, False),
                                         ("c9_tent", wcols.c9, k_a, False),
                                         ("d_nearest", wcols.d, k_c, True)):
            for B in (10, 5):
                h6[f"{name}_B{B}"] = (table, kk[:B].contiguous(), nearest)
        h6["c9_tent_band_B10"] = (wcols.c9, 40 + 4 * torch.rand((10, R9), generator=gen,
                                                                device=dev), False)
        h6["c9_tent_spread_B10"] = (wcols.c9, (K - 1) * torch.rand((10, R9), generator=gen,
                                                                   device=dev), False)
        for name, (table, kb, nearest) in h6.items():
            out = cols.contract_lookup(table, kb, nearest=nearest)
            ref = cols.contract_lookup_ref(table, kb, nearest=nearest)
            err = float((out - ref).nan_to_num().abs().max())
            if not torch.equal(torch.isnan(out), torch.isnan(ref)) or err > (
                    0.0 if nearest else 1.2e-7):
                raise AssertionError(f"H6 under {root} disagrees with its plain version ({name})")
            times[f"H6_{name}"] = graph_ms(
                lambda: cols.contract_lookup(table, kb, nearest=nearest))
            if nearest:  # one torch.gather along K computes the nearest lookup
                idx = torch.round(torch.nan_to_num(kb, nan=0.0).clamp(0, K - 1)).long()
                idx = idx[None].expand(table.shape[0], -1, -1)
                times[f"gather_{name}"] = graph_ms(lambda: torch.gather(table, 1, idx))
        del h6

    if "h7" in groups:
        # H7: the ops phase's tables and index sets, from the flagship worklist
        idx_s = torch.sort(cols.flat_index(wx, wy, nv.PAD_Y, nv.PAD_X, PH, PW), stable=True)[0]
        h7 = {
            "c9_anchors": (cols.gather_rows, vsf.C9,
                           cols.flat_index(ax, ay, nv.PAD_Y, nv.PAD_X, PH, PW)),
            "c36_sorted": (cols.gather_rows_sorted, vsf.C36, idx_s),
            "c36_sorted_int32": (cols.gather_rows_sorted, vsf.C36, idx_s.to(torch.int32)),
            "d": (cols.gather_rows, vsf.D, cols.flat_index(wx, wy, 0, 0, H, W)),
        }
        for name, (entry, volm, idx) in h7.items():
            table = cols.pack_volume_rows(volm).contiguous()
            idx_cl = torch.clamp(idx, 0, table.shape[0] - 1)
            times[f"H7_{name}"] = graph_ms(lambda: entry(table, idx))
            times[f"index_select_{name}"] = graph_ms(
                lambda: torch.index_select(table, 0, idx_cl))
            del table
    if "h9" in groups:
        from apdmvs_tpu_torch.ops import cost_volume as cv

        torch.cuda.empty_cache()
        gen = torch.Generator(device=dev).manual_seed(0)
        E9 = (torch.rand((4, 160, 1216, 1920), generator=gen, device=dev) * 255.0).to(
            torch.bfloat16)
        ref9 = torch.rand((1216, 1920), generator=gen, device=dev) * 255.0
        o36, o9 = torch.empty_like(E9), torch.empty_like(E9)
        if hasattr(cv, "build_cost_volumes"):
            times["H9_dtu"] = graph_ms(lambda: cv.build_cost_volumes(E9, ref9, o36, o9), reps=5)

        def plain():
            for v in range(E9.shape[0]):
                o36[v] = cv.build_cost_volume(E9[v], ref9, 5, 2)
                o9[v] = cv.build_cost_volume(E9[v], ref9, 5, 5)

        plain()
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        plain()
        end.record()
        torch.cuda.synchronize()
        times["H9_plain_dtu"] = start.elapsed_time(end)
        del E9, ref9, o36, o9
    print(f"ABK {sys.argv[1]} " + json.dumps(times), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True)
    print(smi.stdout.strip().splitlines()[0])


if __name__ == "__main__":
    bad = set(sys.argv[2:]) - set(GROUPS)
    if len(sys.argv) < 2 or bad:
        sys.exit(f"usage: ab_kernels.py ROOT [{' '.join(GROUPS)} ...] (unknown: {sorted(bad)})")
    main(sys.argv[1], tuple(sys.argv[2:]) or GROUPS)
