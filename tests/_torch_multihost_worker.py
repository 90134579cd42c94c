"""One process of the port's two-process runs on the CPU
(tests/test_torch_multihost.py). Run:

    APD_COORDINATOR=127.0.0.1:<port> APD_NUM_PROCESSES=2 APD_PROCESS_ID=<i> \\
        python tests/_torch_multihost_worker.py helpers
    ... python tests/_torch_multihost_worker.py lone-fusion
    ... python tests/_torch_multihost_worker.py scene <folder> <num_slices>

``helpers`` starts the gloo group from the APD_* variables and exercises
each exchange helper of ``parallel/multihost.py``; ``lone-fusion`` has
process 0 alone run the one-device ``fuse_eth_device`` while process 1
leaves the group at once, as the batched runner's fusion on process 0
does; ``scene`` runs
``scene.run_scene_batched`` (two rounds) over a 2 x 1 mesh, then the
collective ``scene.run_fusion_device_sharded``. Each prints one JSON line
``WORKER <json>`` with what the test checks.
"""

import hashlib
import json
import sys

import torch

from apdmvs_tpu_torch import fusion, fusion_device, parallel, scene
from apdmvs_tpu_torch.parallel import multihost

torch.set_num_threads(2)


def helpers():
    mesh = parallel.make_mesh(2, 1, device="cpu")
    me = multihost.rank()
    N = 3  # padded to 4: rows [0, 1] and [2] (+ one padding problem)
    local = mesh.local_problems(N)
    depth = torch.stack([torch.full((2, 3), float(n + 1)) for n in local])
    full = multihost.all_gather_rows(depth, mesh.problem_counts(N))
    order = torch.tensor([5, 1 + me, 7], dtype=torch.int64)
    multihost.all_reduce_min_(order)
    claims = torch.tensor([me == 0, me == 1, False])
    multihost.all_reduce_or_(claims)
    multihost.barrier()
    return {
        "rank": me, "world": multihost.world_size(), "local_rows": mesh.local_rows(),
        "owned": multihost.addressable_problems(mesh, 4).tolist(), "local": local,
        "gathered": full[:, 0, 0].tolist(),
        "weak_max": multihost.all_reduce_max(10 * (me + 1)),
        "any_positive": multihost.any_positive(torch.tensor([0.0, float(me)])),
        "none_positive": multihost.any_positive(torch.zeros(2)),
        "min": order.tolist(), "or": claims.tolist(),
    }


def lone_fusion():
    """Process 0's one-device fusion of test_torch_fusion's four views
    (no exchange may reach process 1, which has left); its points'
    digest."""
    from test_torch_fusion import _views

    if multihost.rank() != 0:
        return {"rank": multihost.rank()}
    views, src_ids, _ = _views(fusion)
    coords, colors = fusion_device.fuse_eth_device(views, src_ids, device="cpu")
    return {"rank": 0, "points": int(coords.shape[0]),
            "digest": hashlib.sha256(coords.tobytes() + colors.tobytes()).hexdigest()}


def run_scene(folder, num_slices):
    wrote = []
    fused = []
    persist, fusion = scene._persist, scene.run_fusion

    def spy_persist(problem, *args, **kwargs):
        wrote.append(problem.ref_image_id)
        return persist(problem, *args, **kwargs)

    def spy_fusion(*args, **kwargs):
        fused.append(kwargs.get("variant", "eth"))
        return fusion(*args, **kwargs)

    scene._persist, scene.run_fusion = spy_persist, spy_fusion
    run = scene.run_scene_batched(folder, device="cpu", n_view_shards=2, min_rounds=2,
                                  num_slices=num_slices, verbose=False)
    device_ply = scene.run_fusion_device_sharded(folder, scene.generate_sample_list(folder),
                                                 device="cpu")
    return {"rank": multihost.rank(), "wrote": sorted(set(wrote)), "fused": fused,
            "views": sorted({p.ref_image_id for _, p, _ in run.passes}),
            "device_ply": device_ply}


if __name__ == "__main__":
    assert multihost.maybe_initialize(device="cpu")
    try:
        if sys.argv[1] == "helpers":
            result = helpers()
        elif sys.argv[1] == "lone-fusion":
            result = lone_fusion()
        else:
            result = run_scene(sys.argv[2], int(sys.argv[3]))
        print("WORKER " + json.dumps(result), flush=True)
    finally:
        multihost.shutdown()
