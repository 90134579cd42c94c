"""Two processes of the port over ``torch.distributed`` (gloo) on the CPU,
through tests/_torch_multihost_worker.py (the counterpart of
tests/test_multihost.py).

- Fast tier: the group starts from APD_COORDINATOR / APD_NUM_PROCESSES /
  APD_PROCESS_ID; each process owns its contiguous view rows and problems;
  the depth all-gather returns every process's rows in problem order; the
  WEAK-count maximum, the geometry gate and the device fusion's minimum
  and OR agree on every process. Process 0 alone runs the one-device
  ``fuse_eth_device`` while process 1 has left the group (the batched
  runner's ``--fusion eth-device``): it makes no exchange and returns the
  points of a run without a group.
- Slow (scene-level, as tests/test_multihost.py): a 96x64x8 ring scene
  with two rounds through ``run_scene_batched`` on a 2 x 1 mesh in two
  processes: its state files equal a one-process run's byte for byte, each
  process persists only its own problems, process 0 alone fuses APD.ply,
  and the collective device fusion writes APD_device.ply with the points
  of the one-device ``eth-device`` fusion. The CLI with ``--fusion
  eth-device`` in two processes (64x48x4, one round): process 0's
  ``APD.ply`` holds the one-device fusion's points of the state files.
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(ROOT, "tests", "_torch_multihost_worker.py")
STATE_FILES = ("depths.dmb", "normals.dmb", "weak.bin", "selected_views.bin")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run_processes(command, timeout):
    """``command`` in two processes of one group (the APD_* variables) to
    their end; a failure or a timeout fails the test. Returns each
    process's output."""
    port = _free_port()
    procs = []
    for pid in range(2):
        env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="2",
                   APD_COORDINATOR=f"127.0.0.1:{port}", APD_NUM_PROCESSES="2",
                   APD_PROCESS_ID=str(pid))
        procs.append(subprocess.Popen(command, cwd=ROOT, env=env, stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True))
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    except subprocess.TimeoutExpired:
        pytest.fail("a worker timed out")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"process {pid} failed:\n{out[-4000:]}"
    return outs


def _run_workers(args, timeout):
    """The worker script in two processes; each rank's JSON result."""
    outs = _run_processes([sys.executable, WORKER, *args], timeout)
    return [json.loads(next(ln for ln in out.splitlines()
                            if ln.startswith("WORKER "))[len("WORKER "):]) for out in outs]


def test_two_process_helpers():
    r0, r1 = _run_workers(["helpers"], timeout=300)
    assert (r0["rank"], r1["rank"], r0["world"], r1["world"]) == (0, 1, 2, 2)
    assert (r0["local_rows"], r1["local_rows"]) == ([0], [1])
    assert (r0["owned"], r1["owned"]) == ([0, 1], [2, 3])
    assert (r0["local"], r1["local"]) == ([0, 1], [2])
    for r in (r0, r1):
        assert r["gathered"] == [1.0, 2.0, 3.0]
        assert r["weak_max"] == 20
        assert r["any_positive"] is True and r["none_positive"] is False
        assert r["min"] == [5, 1, 7] and r["or"] == [True, True, False]


def test_lone_device_fusion_makes_no_exchange():
    """Tolerance: exact (the digest of the points and colours)."""
    import hashlib

    from apdmvs_tpu_torch import fusion, fusion_device
    from test_torch_fusion import _views

    r0, r1 = _run_workers(["lone-fusion"], timeout=180)
    assert (r0["rank"], r1["rank"]) == (0, 1)
    views, src_ids, _ = _views(fusion)
    coords, colors = fusion_device.fuse_eth_device(views, src_ids, device="cpu")
    assert r0["points"] == coords.shape[0] > 10000
    assert r0["digest"] == hashlib.sha256(coords.tobytes() + colors.tobytes()).hexdigest()


@pytest.mark.slow
def test_two_process_cli_device_fusion(tmp_path):
    """Tolerance: exact (the points of process 0's APD.ply)."""
    from apdmvs_tpu_torch import fusion_device, scene
    from apdmvs_tpu_torch.datasets import synthetic
    from apdmvs_tpu_torch.io import formats

    cams, planes = synthetic.make_ring_scene(num_views=4, width=64, height=48)
    folder = str(tmp_path / "scene")
    synthetic.write_mvsnet_dataset(folder, cams, planes, depth_ranges=(2.0, 8.0))
    outs = _run_processes([sys.executable, "-m", "apdmvs_tpu_torch", folder, "--device", "cpu",
                           "--num-slices", "32", "--batched", "--view-shards", "2",
                           "--fusion", "eth-device"], timeout=900)
    assert ["Fused point cloud" in out for out in outs] == [True, False]
    views, src_ids = scene._load_fusion_views(folder, scene.generate_sample_list(folder))
    want, _ = fusion_device.fuse_eth_device(views, src_ids, device="cpu")
    got, _ = formats.read_point_cloud(os.path.join(folder, "APD", "APD.ply"))
    assert want.shape[0] > 100
    np.testing.assert_array_equal(got, want)


@pytest.mark.slow
def test_two_process_scene_equals_one_process(tmp_path):
    import torch

    from apdmvs_tpu_torch import fusion_device, scene
    from apdmvs_tpu_torch.datasets import synthetic
    from apdmvs_tpu_torch.io import formats

    torch.set_num_threads(2)
    cams, planes = synthetic.make_ring_scene(num_views=8, width=96, height=64)
    folders = {}
    for name in ("one", "two"):
        folders[name] = str(tmp_path / name)
        synthetic.write_mvsnet_dataset(folders[name], cams, planes, depth_ranges=(2.0, 8.0))
    scene.run_scene_batched(folders["one"], device="cpu", min_rounds=2, num_slices=48,
                            verbose=False)
    r0, r1 = _run_workers(["scene", folders["two"], "48"], timeout=1500)
    assert r0["wrote"] == r0["views"] == [0, 1, 2, 3]
    assert r1["wrote"] == r1["views"] == [4, 5, 6, 7]
    assert (r0["fused"], r1["fused"]) == (["eth"], [])
    for v in range(8):
        for f in STATE_FILES:
            paths = [os.path.join(folders[n], "APD", formats.to_format_index(v), f)
                     for n in ("one", "two")]
            with open(paths[0], "rb") as a, open(paths[1], "rb") as b:
                assert a.read() == b.read(), (v, f)
    ply = [formats.read_point_cloud(os.path.join(folders[n], "APD", "APD.ply"))
           for n in ("one", "two")]
    np.testing.assert_array_equal(ply[0][0], ply[1][0])
    assert ply[0][0].shape[0] > 1500
    problems = scene.generate_sample_list(folders["one"])
    views, src_ids = scene._load_fusion_views(folders["one"], problems)
    want, _ = fusion_device.fuse_eth_device(views, src_ids, device="cpu")
    got, _ = formats.read_point_cloud(r0["device_ply"])
    np.testing.assert_array_equal(got, want)
