"""Space-sharded volumes of the port (``parallel/spaced.py``,
``ncc.build_volume_set_spaced``) and its sharded batch bodies on the CPU,
where every kernel runs its plain version.

- Slabs at S = 2 and 4 (128x96, 4 views, 32 slices): E (interior rows and
  halos), D and the interior rows of C36 and C9 equal the port's unsharded
  set's rows exactly, and so do the C36 / C9 halo rows whose window lies
  inside the slab (the rest carry the slab's own clamped sums, which no
  lookup reads); consts index 20 and geom consts index 32 are s * Hs.
- Against the JAX package's ``build_volume_set_spaced`` on 4 virtual CPU
  devices (128x64): within that package's own bounds
  (tests/test_spaced_volumes.py:139-145): no E sample more than one bf16
  quantum off, under 1e-4 of samples off.
- A REFINE_ITER + geometric + APD pass with a WEAK block on a spaced set,
  S in {2, 4}, equals the unsharded pass with the same draws bit for bit
  (depth, normal, pixel_state, selected, costs); the spaced weak columns
  equal ``build_weak_cols``' exactly for C36, C9 and D, with anchors on
  slab boundaries, on halo rows and missing.
- ``sharded_batch_pass`` on meshes (1, 4), (2, 1) and (2, 2) of CPU
  shards equals (1, 1) bit for bit: two problems with rotated view sets
  and a geometric APD pass (tests/test_spaced_volumes.py:198-260).
- ``default_devices`` with 1, 2 and 4 cards (``torch.cuda.device_count``
  monkeypatched): one shard a card, a card repeated only on a machine with
  one card, a ``ValueError`` with two cards and four shards; a named card,
  the CPU and an explicit ``devices=`` list taken as given; one card a
  process in a run of several.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apdmvs_tpu_torch import geometry, ncc, parallel, pipeline, rng, weak
from apdmvs_tpu_torch.datasets import synthetic
from apdmvs_tpu_torch.ops import ncc_volume
from apdmvs_tpu_torch.params import PassConfig, PixelState, RunState

torch.set_num_threads(2)

DMIN, DMAX = 2.0 * 0.6, 8.0 * 1.2
SLICES = 32
PAD_Y = ncc_volume.PAD_Y
RADIUS = 5  # the window radius of C36 and C9
CFG = PassConfig(state=RunState.REFINE_ITER, geom_consistency=True, use_APD=True,
                 max_iterations=1, weak_peak_radius=4)


@functools.lru_cache(maxsize=None)
def _scene(width=128, height=96, views=4):
    cams, _ = synthetic.make_ring_scene(num_views=views, width=width, height=height,
                                        include_flat_region=True)
    images, depths, normals = synthetic.render_scene(cams, _)
    K = np.stack([c.K for c in cams]).astype(np.float32)
    R = np.stack([c.R for c in cams]).astype(np.float32)
    t = np.stack([c.t for c in cams]).astype(np.float32)
    return images, depths, normals, K, R, t


def _cams(K, R, t):
    V = K.shape[-3]
    lead = K.shape[:-3]
    return geometry.make_cameras(K, R, t, np.full(lead + (V,), DMIN, np.float32),
                                 np.full(lead + (V,), DMAX, np.float32))


def _unsharded(images, cams, depths, weak_cost_volumes=True):
    vs = ncc.build_image_volume_set(images, cams, DMIN, DMAX, num_slices=SLICES,
                                    weak_cost_volumes=weak_cost_volumes)
    return ncc.add_depth_volumes(vs, depths, cams, DMIN, DMAX)


@pytest.fixture(scope="module")
def volumes():
    images, depths, normals, K, R, t = _scene()
    imgs, dm = torch.as_tensor(images), torch.as_tensor(depths)
    cams = _cams(K, R, t)
    return imgs, dm, cams, _unsharded(imgs, cams, dm)


@pytest.mark.parametrize("S", [2, 4])
def test_slabs_equal_unsharded_rows(volumes, S):
    imgs, dm, cams, vu = volumes
    H = imgs.shape[1]
    sp = ncc.build_volume_set_spaced(imgs, cams, DMIN, DMAX, ["cpu"] * S, num_slices=SLICES,
                                     depth_maps=dm)
    assert sp.spaced and not vu.spaced and sp.S == S and sp.Hp == sp.S * sp.Hs
    checked = 0
    for s, sl in enumerate(sp.slabs):
        r0, r1 = sp.slab_rows(s)
        assert float(sl.consts[0, 0, 20]) == r0 and float(sl.geom_consts[0, 0, 32]) == r0
        assert torch.equal(sl.consts[..., :20], vu.consts[..., :20])
        # E: every stored row, halos included, that the unsharded grid holds
        # (global padded rows [r0, r0 + Hs + 2 PAD_Y))
        n = min(r1 + 2 * PAD_Y, vu.E.shape[2]) - r0
        assert torch.equal(sl.E[:, :, :n], vu.E[:, :, r0:r0 + n]), (s, "E")
        # D: the interior rows (no halo)
        n = min(r1, vu.D.shape[2]) - r0
        assert n <= 0 or torch.equal(sl.D[:, :, :n], vu.D[:, :, r0:r0 + n]), (s, "D")
        # C36 / C9: image rows whose window lies in the slab; at the grid's
        # top every halo row (slab 0's top edge is the grid's)
        lo = 0 if s == 0 else RADIUS
        hi = min(sp.Hs + 2 * PAD_Y - RADIUS, H + PAD_Y - r0)
        for name in ("C36", "C9"):
            a, b = getattr(sl, name), getattr(vu, name)
            if hi > lo:
                assert torch.equal(a[:, :, lo:hi], b[:, :, r0 + lo:r0 + hi]), (s, name)
                checked += hi - lo
    assert checked > 0


def test_slabs_match_the_reference_package_spaced_build():
    """S = 4 at 128x64 on the JAX package's virtual CPU devices (its own
    slab test's setup, tests/test_spaced_volumes.py:108-145), within its
    bounds: no E sample more than one bf16 quantum (1 grey level) off,
    under 1e-4 of samples off; the same row0 in every slab's consts."""
    from jax.sharding import Mesh

    from apdmvs_tpu import geometry as jgeom, ncc as jncc

    images, _, _, K, R, t = _scene(128, 64)
    V = K.shape[0]
    S = 4
    jc = jgeom.make_cameras(K, R, t, np.full(V, DMIN, np.float32),
                            np.full(V, DMAX, np.float32))
    mesh = Mesh(np.asarray(jax.devices()[:S]).reshape(1, S), ("view", "space"))
    js = jncc.build_volume_set_spaced(jnp.asarray(images), jc, DMIN, DMAX, mesh,
                                      num_slices=SLICES, weak_cost_volumes=False)
    sp = ncc.build_volume_set_spaced(torch.as_tensor(images), _cams(K, R, t), DMIN, DMAX,
                                     ["cpu"] * S, num_slices=SLICES, weak_cost_volumes=False)
    jE = np.asarray(js.E.astype(jnp.float32))  # [S, V-1, K, Hs+16, PW]
    assert jE.shape[-2] - 2 * PAD_Y == sp.Hs
    for s, sl in enumerate(sp.slabs):
        d = np.abs(sl.E.float().numpy() - jE[s])
        assert (d > 1.0).mean() == 0.0, (s, d.max())
        assert (d > 0).mean() < 1e-4, (s, (d > 0).mean())
        np.testing.assert_array_equal(sl.consts.numpy()[..., 20],
                                      np.asarray(js.consts)[s][..., 20])


def _prior(depths, normals, H, W, V):
    ps = np.full((H, W), PixelState.STRONG, np.uint8)
    ps[H // 3:2 * H // 3, W // 3:2 * W // 3] = PixelState.WEAK
    sv = torch.arange(V) > 0
    return sv, pipeline.PassState(
        depth=torch.as_tensor(depths[0]), normal_world=torch.as_tensor(normals[0]),
        pixel_state=torch.as_tensor(ps), selected=sv[:, None, None].expand(V, H, W).clone())


@pytest.fixture(scope="module")
def unsharded_pass(volumes):
    imgs, dm, cams, vu = volumes
    images, depths, normals, *_ = _scene()
    V, H, W = images.shape
    sv, prior = _prior(depths, normals, H, W, V)
    out = pipeline.patchmatch_pass(cams, sv, prior, rng.TorchDraws(3, H, W, "cpu"), CFG, vu,
                                   weak_capacity=2048, ransac_threshold=0.00875)
    return sv, prior, out


@pytest.mark.parametrize("S", [2, 4])
def test_spaced_pass_equals_unsharded_bit_for_bit(volumes, unsharded_pass, S):
    """Tolerance: bit for bit (torch.equal), every field."""
    imgs, dm, cams, _ = volumes
    sv, prior, ref = unsharded_pass
    V, H, W = imgs.shape
    sp = ncc.build_volume_set_spaced(imgs, cams, DMIN, DMAX, ["cpu"] * S, num_slices=SLICES,
                                     depth_maps=dm)
    out = pipeline.patchmatch_pass(cams, sv, prior, rng.TorchDraws(3, H, W, "cpu"), CFG, sp,
                                   weak_capacity=2048, ransac_threshold=0.00875)
    assert int((prior.pixel_state == PixelState.WEAK).sum()) > 500
    for name, a, b in zip(ref._fields, ref, out):
        assert torch.equal(a, b), name


@pytest.mark.parametrize("S", [2, 4])
def test_spaced_columns_equal_build_weak_cols(volumes, S):
    """Worklist pixels and anchors on every slab boundary row, on the halo
    rows either side, at the grid's first and last rows, and missing (-1):
    the spaced columns equal the unsharded ones exactly (torch.equal)."""
    imgs, dm, cams, vu = volumes
    V, H, W = imgs.shape
    sp = ncc.build_volume_set_spaced(imgs, cams, DMIN, DMAX, ["cpu"] * S, num_slices=SLICES,
                                     depth_maps=dm)
    rows = sorted({y for s in range(S) for r in sp.slab_rows(s)
                   for y in (r - 1, r, r + 1) if 0 <= y < H} | {0, H - 1})
    gen = np.random.RandomState(S)
    xs = gen.randint(0, W, size=len(rows))
    weak_xy = torch.as_tensor(np.stack([np.append(xs, -1), np.append(rows, -1)], 1))
    N = weak_xy.shape[0]
    ay = gen.choice(rows + [-1], size=(N, 8))
    ax = np.where(ay < 0, -1, gen.randint(0, W, size=(N, 8)))
    coords = torch.cat([weak_xy[:, None], torch.as_tensor(np.stack([ax, ay], -1))], 1)
    anchors = weak.AnchorData(coords=coords)
    want = weak.build_weak_cols(ncc.make_context(cams, torch.arange(V) > 0, H, W, vu),
                                weak_xy, anchors)
    got = weak.build_weak_cols(ncc.make_context(cams, torch.arange(V) > 0, H, W, sp),
                               weak_xy, anchors)
    for name, a, b in zip(want._fields, want, got):
        assert torch.equal(a, b), name


def test_spaced_set_refuses_point_lookups(volumes):
    imgs, dm, cams, _ = volumes
    V, H, W = imgs.shape
    sp = ncc.build_volume_set_spaced(imgs, cams, DMIN, DMAX, ["cpu", "cpu"], num_slices=SLICES)
    ctx = ncc.make_context(cams, torch.arange(V) > 0, H, W, sp)
    plane = torch.tensor([[0.0, 0.0, -1.0, 4.0]])
    xy = torch.tensor([3])
    with pytest.raises(ValueError, match="full grids only"):
        ncc.cost_vector(ctx, plane, 5, 2, xs=xy.float(), ys=xy.float())
    with pytest.raises(ValueError, match="slab 0 must live"):
        ncc.build_volume_set_spaced(imgs, cams, DMIN, DMAX, ["meta", "cpu"], num_slices=SLICES)


@pytest.fixture(scope="module")
def two_problems():
    """Problems of ref views 0 and 1 (view sets rotated), 96x64, a WEAK
    block, depths and normals from the ground truth."""
    images, depths, normals, K, R, t = _scene(96, 64)
    V, H, W = images.shape
    orders = [[0, 1, 2, 3], [1, 2, 3, 0]]
    N = len(orders)
    cams = _cams(np.stack([K[o] for o in orders]), np.stack([R[o] for o in orders]),
                 np.stack([t[o] for o in orders]))
    ps = np.full((N, H, W), PixelState.STRONG, np.uint8)
    ps[:, H // 3:2 * H // 3, W // 3:2 * W // 3] = PixelState.WEAK
    sv = (torch.arange(V) > 0)[None].expand(N, V).clone()
    prior = pipeline.PassState(
        depth=torch.as_tensor(depths[:N]), normal_world=torch.as_tensor(normals[:N]),
        pixel_state=torch.as_tensor(ps), selected=sv[:, :, None, None].expand(N, V, H, W).clone())
    return (torch.as_tensor(np.stack([images[o] for o in orders])), cams, sv, prior,
            torch.as_tensor(depths[:N]), np.asarray(orders) % N)


def _batch(two_problems, mesh):
    imgs, cams, sv, prior, all_depths, src_index = two_problems
    N, V, H, W = imgs.shape
    draws = [rng.TorchDraws(11 + i, H, W, mesh.problem_device(i, N)) for i in range(N)]
    return parallel.sharded_batch_pass(
        imgs, cams, sv, prior, draws, np.full(N, 0.00875), CFG, weak_capacity=1024,
        all_depths=all_depths, src_index=src_index, use_volumes=True, num_slices=SLICES,
        mesh=mesh)


@pytest.fixture(scope="module")
def one_shard(two_problems):
    return _batch(two_problems, parallel.make_mesh(1, 1, device="cpu"))


@pytest.mark.parametrize("n_view,n_space", [(1, 4), (2, 1), (2, 2)])
def test_sharded_batch_pass_equals_one_shard(two_problems, one_shard, n_view, n_space):
    """Tolerance: bit for bit (torch.equal), every field of both problems."""
    out = _batch(two_problems, parallel.make_mesh(n_view, n_space, device="cpu"))
    for name, a, b in zip(one_shard._fields, one_shard, out):
        assert torch.equal(a, b), name


def test_mesh_layout_and_problem_blocks():
    mesh = parallel.make_mesh(2, 3, device="cpu")
    assert mesh.n_view == 2 and mesh.n_space == 3 and mesh.local_rows() == [0, 1]
    assert all(len(row) == 3 for row in mesh.devices)
    # 5 problems over 2 rows: padded to 6, contiguous blocks of 3 (P("view"))
    assert parallel.problem_blocks(5, 2) == (6, 3)
    assert [list(mesh.row_problems(r, 5)) for r in (0, 1)] == [[0, 1, 2], [3, 4]]
    assert mesh.local_problems(5) == [0, 1, 2, 3, 4] and mesh.problem_counts(5) == [5]
    assert list(parallel.multihost.addressable_problems(mesh, 6)) == list(range(6))
    with pytest.raises(ValueError, match="need 6 devices"):
        parallel.make_mesh(2, 3, devices=["cpu"] * 4)
    assert parallel.default_view_shards("cpu", 1, 5) == 1


@pytest.mark.parametrize("cards", [1, 2, 4])
def test_default_devices_never_pile_shards_onto_one_card(monkeypatch, cards):
    """The default layout puts one shard on each card; it repeats a card
    only on a machine with one card, and with more cards than one but fewer
    than the shards it refuses (``devices=`` lays them out by hand). A
    named card, the CPU and an explicit device list are taken as given, and
    a process of several takes one card."""
    from apdmvs_tpu_torch.parallel import multihost, sharded

    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 1)
    cuda = [torch.device("cuda", i) for i in range(4)]
    assert sharded.default_devices("cuda", 1) == cuda[:1]
    assert sharded.default_devices("cuda", 2) == (cuda[:1] * 2 if cards == 1 else cuda[:2])
    if cards == 2:
        with pytest.raises(ValueError, match="4 shards but 2 cards.*devices="):
            sharded.default_devices("cuda", 4)
        with pytest.raises(ValueError, match="pass devices="):
            parallel.make_mesh(2, 2, device="cuda")
    else:
        assert sharded.default_devices("cuda", 4) == (cuda[:1] * 4 if cards == 1 else cuda)
        mesh = parallel.make_mesh(2, 2, device="cuda")
        assert [d for row in mesh.devices for d in row] == sharded.default_devices("cuda", 4)
    assert sharded.default_devices("cuda:1", 3) == [cuda[1]] * 3
    assert sharded.default_devices("cpu", 3) == [torch.device("cpu")] * 3
    explicit = parallel.make_mesh(2, 2, devices=["cuda:0"] * 4, device="cuda")
    assert [d for row in explicit.devices for d in row] == [cuda[0]] * 4
    monkeypatch.setattr(multihost, "world_size", lambda: 2)
    assert sharded.default_devices("cuda", 3) == [cuda[1]] * 3
