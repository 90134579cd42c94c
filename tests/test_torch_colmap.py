"""The port's copy of the COLMAP -> MVSNet converter: tests/test_colmap.py's
cases run on the copy, and the copy's dataset equals the JAX package's
converter's byte for byte (reference behavior: colmap2mvsnet.py; SURVEY.md
§2.7)."""

import os
import struct

import numpy as np
import pytest

from apdmvs_tpu.datasets import colmap as jcolmap
from apdmvs_tpu_torch.datasets import colmap, synthetic
from apdmvs_tpu_torch.io import formats


def _make_model(tmp, ext):
    """Write a small consistent COLMAP model in txt or bin form: 3 cameras
    on a baseline viewing a point cloud ~4m away."""
    rng = np.random.RandomState(0)
    pts = rng.uniform([-1.5, -1.0, 3.0], [1.5, 1.0, 5.0], size=(60, 3))
    cams = []
    for i in range(3):
        R, t = synthetic.look_at(np.array([0.4 * i - 0.4, 0.0, 0.0]), np.array([0.0, 0.0, 4.0]))
        cams.append((R, t))
    # visibility: image i sees points [0:40+10i]
    vis = [list(range(0, 40)), list(range(5, 50)), list(range(10, 60))]

    model_dir = os.path.join(tmp, "sparse")
    os.makedirs(model_dir, exist_ok=True)
    W, H, f = 640, 480, 500.0

    if ext == ".txt":
        with open(os.path.join(model_dir, "cameras.txt"), "w") as fh:
            fh.write("# comment\n")
            fh.write(f"1 PINHOLE {W} {H} {f} {f} {W/2} {H/2}\n")
        with open(os.path.join(model_dir, "images.txt"), "w") as fh:
            for i, (R, t) in enumerate(cams):
                q = colmap.rotmat2qvec(R)
                fh.write(
                    f"{i+1} {q[0]} {q[1]} {q[2]} {q[3]} {t[0]} {t[1]} {t[2]} 1 img_{i}.png\n"
                )
                fh.write(
                    " ".join(f"{10.0+j} {20.0+j} {pid+1}" for j, pid in enumerate(vis[i]))
                    + "\n"
                )
        with open(os.path.join(model_dir, "points3D.txt"), "w") as fh:
            for pid, p in enumerate(pts):
                fh.write(f"{pid+1} {p[0]} {p[1]} {p[2]} 100 110 120 0.5 1 0 2 0\n")
    else:
        with open(os.path.join(model_dir, "cameras.bin"), "wb") as fh:
            fh.write(struct.pack("<Q", 1))
            fh.write(struct.pack("<iiQQ", 1, 1, W, H))
            fh.write(struct.pack("<4d", f, f, W / 2, H / 2))
        with open(os.path.join(model_dir, "images.bin"), "wb") as fh:
            fh.write(struct.pack("<Q", len(cams)))
            for i, (R, t) in enumerate(cams):
                q = colmap.rotmat2qvec(R)
                fh.write(struct.pack("<i", i + 1))
                fh.write(struct.pack("<4d", *q))
                fh.write(struct.pack("<3d", *t))
                fh.write(struct.pack("<i", 1))
                fh.write(f"img_{i}.png".encode() + b"\x00")
                fh.write(struct.pack("<Q", len(vis[i])))
                for j, pid in enumerate(vis[i]):
                    fh.write(struct.pack("<ddq", 10.0 + j, 20.0 + j, pid + 1))
        with open(os.path.join(model_dir, "points3D.bin"), "wb") as fh:
            fh.write(struct.pack("<Q", len(pts)))
            for pid, p in enumerate(pts):
                fh.write(struct.pack("<Q", pid + 1))
                fh.write(struct.pack("<3d", *p))
                fh.write(struct.pack("<3B", 100, 110, 120))
                fh.write(struct.pack("<d", 0.5))
                fh.write(struct.pack("<Q", 1))
                fh.write(struct.pack("<ii", 1, 0))

    # images of slightly different sizes (conversion pads to common max)
    from PIL import Image

    img_dir = os.path.join(tmp, "images")
    os.makedirs(img_dir, exist_ok=True)
    for i in range(3):
        w = W - 4 * i
        Image.fromarray(
            np.full((H, w, 3), 100 + 20 * i, np.uint8)
        ).save(os.path.join(img_dir, f"img_{i}.png"))
    return tmp


def test_qvec_roundtrip():
    rng = np.random.RandomState(1)
    for _ in range(10):
        R, _ = synthetic.look_at(rng.randn(3), rng.randn(3) + np.array([0, 0, 5.0]))
        q = colmap.rotmat2qvec(R)
        R2 = colmap.qvec2rotmat(q)
        np.testing.assert_allclose(R, R2, atol=1e-10)


@pytest.mark.parametrize("ext", [".txt", ".bin"])
def test_convert(tmp_path, ext):
    tmp = str(tmp_path)
    _make_model(tmp, ext)
    out = os.path.join(tmp, "mvsnet")
    colmap.convert(
        tmp, out, model_dir=os.path.join(tmp, "sparse"), model_ext=ext,
        scale_factor=2.0,
    )

    # cams: readable by the pipeline's reader, K scaled by 1/2
    cam0 = formats.read_camera(os.path.join(out, "cams", "00000000_cam.txt"))
    assert abs(cam0["K"][0, 0] - 250.0) < 1e-3
    assert 0.0 < cam0["depth_min"] < cam0["depth_max"] < 10.0
    # depth range is the sparse-z percentile band around ~3..5m
    assert cam0["depth_min"] < 3.5 and cam0["depth_max"] > 4.0

    # extrinsics round-trip through qvec
    R0, _ = synthetic.look_at(np.array([-0.4, 0.0, 0.0]), np.array([0.0, 0.0, 4.0]))
    np.testing.assert_allclose(cam0["R"], R0, atol=1e-5)

    # pair.txt: 3 images, 2 sources each, shared-point scores > 0
    pairs = formats.read_pair_file(os.path.join(out, "pair.txt"))
    assert len(pairs) == 3
    for ref_id, srcs in pairs:
        assert len(srcs) == 2
        assert all(s > 0 for _, s in srcs)
    # image 0 shares more points with image 1 (35) than image 2 (30)
    assert pairs[0][1][0][0] == 1

    # images: all padded to common size then halved
    from PIL import Image

    for i in range(3):
        with Image.open(os.path.join(out, "images", f"{i:08d}.jpg")) as im:
            assert im.size == (320, 240)


def test_bin_txt_identical(tmp_path):
    ta = os.path.join(str(tmp_path), "a")
    tb = os.path.join(str(tmp_path), "b")
    os.makedirs(ta)
    os.makedirs(tb)
    _make_model(ta, ".txt")
    _make_model(tb, ".bin")
    ca, ia, pa = colmap.read_model(os.path.join(ta, "sparse"), ".txt")
    cb, ib, pb = colmap.read_model(os.path.join(tb, "sparse"), ".bin")
    assert ca.keys() == cb.keys()
    np.testing.assert_allclose(ca[1].params, cb[1].params)
    for k in ia:
        np.testing.assert_allclose(ia[k].qvec, ib[k].qvec, atol=1e-12)
        np.testing.assert_array_equal(ia[k].point3D_ids, ib[k].point3D_ids)
    for k in pa:
        np.testing.assert_allclose(pa[k].xyz, pb[k].xyz)


@pytest.mark.parametrize("ext", [".txt", ".bin"])
def test_copy_writes_the_same_dataset(tmp_path, ext):
    tmp = str(tmp_path)
    _make_model(tmp, ext)
    outs = []
    for mod, name in ((jcolmap, "jax"), (colmap, "port")):
        out = os.path.join(tmp, name)
        mod.convert(tmp, out, model_dir=os.path.join(tmp, "sparse"), model_ext=ext,
                    scale_factor=2.0)
        outs.append(out)
    files = sorted(os.path.relpath(os.path.join(d, f), outs[0])
                   for d, _, fs in os.walk(outs[0]) for f in fs)
    assert files == sorted(os.path.relpath(os.path.join(d, f), outs[1])
                           for d, _, fs in os.walk(outs[1]) for f in fs)
    assert "pair.txt" in files and len(files) == 7
    for f in files:
        with open(os.path.join(outs[0], f), "rb") as a, open(os.path.join(outs[1], f), "rb") as b:
            assert a.read() == b.read(), f
