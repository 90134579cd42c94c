"""Device times of H1 and H2 of the port found under ROOT.

    python apdmvs_tpu_torch/ab_kernels.py ROOT

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
  the package has it, else four one-view calls.

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


def main(root: str) -> None:
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
        times["H2_C9_4views"] = graph_ms(lambda: nv.ncc_cost_views(Es, ref_pad, pcf, consts_v, K))
    else:
        times["H2_C9_4views"] = graph_ms(
            lambda: [nv.ncc_cost(Es[v], ref_pad, pcf, consts_v[v], K) for v in range(V - 1)])
    print(f"ABK {sys.argv[1]} " + json.dumps(times), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True)
    print(smi.stdout.strip().splitlines()[0])


if __name__ == "__main__":
    main(sys.argv[1])
