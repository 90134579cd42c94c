"""The compiled pass (``apdmvs_tpu_torch/compiled.py``,
``pipeline.patchmatch_pass`` / ``patchmatch_pass_impl``) on the CPU.

A CUDA graph needs a card, so the tests hold what the capture rests on:

- the static compaction of the worklist equals ``torch.nonzero``'s and the
  JAX package's ``compact_weak_pixels`` (``jnp.nonzero(size=)``) for
  random states, at capacities below, at and above the WEAK count;
- a pass fed by a draw plan (recorded from ``TorchDraws`` and from
  ``JaxDraws``, then filled from a fresh source of the same seed) equals
  the pass fed directly, bit for bit, with APD and geometric consistency;
- the static key separates every static argument and maps two problems
  that differ only in cameras, prior and ``ransac_threshold`` to one key
  (a spaced set on the pass's device has a key of its own; slabs on
  another device raise), and the body run on filled slots equals it run
  on the originals, bit for bit, on the volume and the direct-warp paths
  (spaced sets: ``tests/test_torch_compiled_spaced.py``);
- under a ``TorchDispatchMode`` the body dispatches none of the operators
  a capture refuses: ``nonzero``, ``_local_scalar_dense`` (a host read),
  ``masked_select``, ``unique*``, a boolean index (``index`` /
  ``index_put`` over a mask, which count on the host) and ``lift_fresh``
  (a tensor made from host data: a host-to-device copy on a card);
- ``profile_stages`` and ``trace_pass`` run with
  ``pipeline.patchmatch_pass`` made to raise: they call the body;
- ``scene.volume_cache_budget`` with the card's memory monkeypatched: 80
  GB pins five 1280x960 sets, 16 GB none; an explicit budget wins.

Tolerance: bit for bit (``torch.equal``) wherever a pass is compared.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from _torch_parity import JaxDraws, flat_ring_scene, t
from apdmvs_tpu import weak as jweak
from apdmvs_tpu_torch import (compiled, ncc, parallel, pipeline, profile_stages, rng, scene,
                              trace_pass, weak)
from apdmvs_tpu_torch.params import PassConfig, PixelState, RunState

torch.set_num_threads(2)

DMIN, DMAX = 2.0 * 0.6, 8.0 * 1.2
K = 32
CFG = PassConfig(state=RunState.REFINE_ITER, geom_consistency=True, use_APD=True,
                 max_iterations=2, weak_peak_radius=4)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_static_compaction_equals_nonzero(seed):
    rs = np.random.RandomState(seed)
    H, W = 48, 64
    state = rs.randint(0, 3, (H, W)).astype(np.uint8)
    ps = torch.as_tensor(state)
    n = int((state == PixelState.WEAK).sum())
    ys, xs = torch.nonzero(ps == PixelState.WEAK, as_tuple=True)
    for cap in (1, n // 3, n - 1, n, n + 1, n + 500):
        want = torch.full((cap, 2), -1, dtype=torch.int64)
        k = min(cap, n)
        want[:k, 0], want[:k, 1] = xs[:k], ys[:k]
        got = weak.compact_weak_pixels(ps, cap)
        assert torch.equal(got, want), cap
        jax_xy = np.asarray(jweak.compact_weak_pixels(jnp.asarray(state), cap))
        assert np.array_equal(got.numpy(), jax_xy.astype(np.int64)), cap


@pytest.fixture(scope="module")
def small():
    """The textureless-window ring scene at 48x32x3: cameras, images and
    depths (tensors), normals, and a prior from the ground truth with a WEAK
    block."""
    sc = flat_ring_scene(num_views=3, width=48, height=32)
    V, H, W = sc["V"], sc["H"], sc["W"]
    imgs, dms = t(sc["images"]), t(sc["depths"])
    ps = torch.full((H, W), int(PixelState.STRONG), dtype=torch.uint8)
    ps[H // 4:3 * H // 4, W // 4:3 * W // 4] = int(PixelState.WEAK)
    sv = torch.arange(V) > 0
    prior = pipeline.PassState(depth=dms[0], normal_world=t(sc["normals"][0]), pixel_state=ps,
                               selected=sv[:, None, None].expand(V, H, W).clone())
    vs = ncc.add_depth_volumes(ncc.build_image_volume_set(imgs, sc["tcams"], DMIN, DMAX, K),
                               dms, sc["tcams"], DMIN, DMAX)
    return dict(sc=sc, imgs=imgs, dms=dms, sv=sv, prior=prior, vs=vs, cap=1024)


def _pass(small, draws, path="volumes", **over):
    kw = dict(cams=small["sc"]["tcams"], src_valid=small["sv"], prior=small["prior"],
              draws=draws, cfg=CFG, volumes=small["vs"] if path == "volumes" else None,
              weak_capacity=small["cap"], ransac_threshold=0.00875, images=small["imgs"],
              depth_maps=small["dms"])
    kw.update(over)
    return pipeline.patchmatch_pass_impl(**kw)


def _assert_equal(a, b):
    for name, x, y in zip(a._fields, a, b):
        assert torch.equal(x, y), name


@pytest.mark.parametrize("source", ["torch", "jax"])
def test_draw_plan_feeds_the_pass_bit_for_bit(small, source):
    import jax

    H, W = small["sc"]["H"], small["sc"]["W"]

    def fresh():
        return (rng.TorchDraws(7, H, W, "cpu") if source == "torch"
                else JaxDraws(jax.random.PRNGKey(7), H, W))

    direct = _pass(small, fresh())
    plan, recorder = rng.DrawPlan.record(fresh(), "cpu")
    recorded = _pass(small, recorder)
    _assert_equal(recorded, direct)
    names = [name for name, _ in plan.requests]
    assert names[0] == "anchor_probes" and "fit_ransac" in names and "weak_refinement" in names
    for slots in plan.slots:  # a replay's fill overwrites whatever the slots hold
        for slot in slots if isinstance(slots, tuple) else (slots,):
            slot.zero_()
    plan.fill(fresh())
    _assert_equal(_pass(small, plan.reader()), direct)
    with pytest.raises(RuntimeError, match="the plan holds"):
        _pass(small, plan.reader(), cfg=dataclasses.replace(CFG, max_iterations=3))


def test_static_key_separates_static_arguments(small):
    sc, prior, vs = small["sc"], small["prior"], small["vs"]
    key = compiled.static_key(sc["tcams"], prior, CFG, vs, 1024, False)
    cams2 = sc["tcams"]._replace(K=sc["tcams"].K * 1.01, R=sc["tcams"].R.flip(0))
    prior2 = prior._replace(depth=prior.depth + 1.0,
                            pixel_state=torch.zeros_like(prior.pixel_state))
    vs2 = vs._replace(E=vs.E + 1, D=vs.D * 2)
    assert compiled.static_key(cams2, prior2, CFG, vs2, 1024, False) == key
    others = [
        compiled.static_key(sc["tcams"], prior, dataclasses.replace(CFG, use_APD=False), vs,
                            1024, False),
        compiled.static_key(sc["tcams"], prior, dataclasses.replace(CFG, max_iterations=3), vs,
                            1024, False),
        compiled.static_key(sc["tcams"], prior, CFG, vs, 1536, False),
        compiled.static_key(sc["tcams"], prior, CFG, vs, 1024, True),
        compiled.static_key(sc["tcams"], prior, CFG, vs._replace(D=None), 1024, False),
        compiled.static_key(sc["tcams"], prior, CFG, vs._replace(C9=None), 1024, False),
        compiled.static_key(sc["tcams"], prior, CFG, None, 1024, False),
        compiled.static_key(sc["tcams"], prior,
                            dataclasses.replace(CFG, geom_consistency=False), None, 1024,
                            False),
        compiled.static_key(sc["tcams"], prior._replace(depth=prior.depth[:-8]), CFG, vs, 1024,
                            False),
    ]
    assert len({key, *others}) == len(others) + 1
    spaced = ncc.build_volume_set_spaced(small["imgs"], sc["tcams"], DMIN, DMAX, ["cpu"] * 2,
                                         num_slices=K)
    assert compiled.static_key(sc["tcams"], prior, CFG, spaced, 1024, False) not in {
        key, *others}
    spread = spaced._replace(slabs=(spaced.slabs[0], type(spaced.slabs[1])(
        *(None if f is None else f.to("meta") for f in spaced.slabs[1]))))
    with pytest.raises(ValueError, match="patchmatch_pass_impl"):
        compiled.static_key(sc["tcams"], prior, CFG, spread, 1024, False)


@pytest.mark.parametrize("path", ["volumes", "direct"])
def test_body_on_filled_slots_equals_the_originals(small, path):
    """The slots a capture reads, filled from the originals (and, for a
    second problem with other cameras, prior and ransac threshold, filled
    again), give the body's results on the originals."""
    sc = small["sc"]
    H, W = sc["H"], sc["W"]
    st = compiled._DeviceGraphs()
    second = dict(cams=sc["tcams"]._replace(K=sc["tcams"].K * 1.002),
                  prior=small["prior"]._replace(depth=small["prior"].depth * 1.01),
                  ransac_threshold=0.0125)
    slots = None
    for over in ({}, second):
        kw = dict(cams=sc["tcams"], prior=small["prior"], ransac_threshold=0.00875)
        kw.update(over)
        args = compiled._arguments(kw["cams"], small["sv"], kw["prior"],
                                   small["vs"] if path == "volumes" else None,
                                   kw["ransac_threshold"], small["imgs"], small["dms"], CFG)
        if slots is None:
            slots = st.input_slots(args, "cpu")
        else:
            for role, slot in slots.items():
                st.fill(slot, args[role])
        assert set(slots) == set(args)
        assert all(slots[role] is not v for role, v in args.items())
        assert slots["ransac_threshold"].shape == () and float(
            slots["ransac_threshold"]) == pytest.approx(kw["ransac_threshold"])
        want = compiled._body(args, rng.TorchDraws(3, H, W, "cpu"), CFG, small["cap"], False)
        got = compiled._body(slots, rng.TorchDraws(3, H, W, "cpu"), CFG, small["cap"], False)
        _assert_equal(got, want)


def test_slot_fill_copies_again_after_a_change():
    st = compiled._DeviceGraphs()
    src = torch.arange(6.0)
    slot = st.slot("x", src, "cpu")
    st.fill(slot, src)
    slot.zero_()  # no copy while the source is the same tensor, unchanged
    st.fill(slot, src)
    assert float(slot.sum()) == 0.0
    src.add_(1.0)  # a new version
    st.fill(slot, src)
    assert torch.equal(slot, src)
    st.fill(slot, src.clone())  # another tensor
    assert torch.equal(slot, src)


class _Refused(TorchDispatchMode):
    """Records the operators a CUDA-graph capture refuses, outside the
    kernel wrappers (on a card they launch their kernels; here they run
    their plain versions, which no capture sees)."""

    NAMES = ("nonzero", "_local_scalar_dense", "masked_select", "unique", "lift_fresh")

    def __init__(self):
        super().__init__()
        self.seen = set()
        self.in_kernel = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if self.in_kernel:
            return func(*args, **(kwargs or {}))
        name = func.overloadpacket.__name__
        if any(name.startswith(n) for n in self.NAMES):
            self.seen.add(name)
        if name in ("index", "index_put", "index_put_"):
            idx = args[1]
            if any(isinstance(i, torch.Tensor) and i.dtype == torch.bool for i in idx):
                self.seen.add(f"{name} with a boolean index")
        return func(*args, **(kwargs or {}))


def refused_operators(monkeypatch, args, H, W, cap, layout=None) -> set:
    """The refused operators the body dispatches on ``args`` (outside the
    kernel wrappers), after a recording pass."""
    mode = _Refused()
    from apdmvs_tpu_torch.ops import cols, ncc_volume

    for mod, name in ((ncc_volume, "ncc_cost_views"), (ncc_volume, "geom_cost_views"),
                      (cols, "gather_cols"), (cols, "contract_lookup")):
        def kernel(*args, _fn=getattr(mod, name), **kwargs):
            mode.in_kernel += 1
            try:
                return _fn(*args, **kwargs)
            finally:
                mode.in_kernel -= 1

        monkeypatch.setattr(mod, name, kernel)
    # debug=True runs every stage of debug=False and returns the probes too;
    # the recording pass also makes the device constants, as a warm-up does
    plan, recorder = rng.DrawPlan.record(rng.TorchDraws(3, H, W, "cpu"), "cpu")
    compiled._body(args, recorder, CFG, cap, True, layout)
    with mode:
        compiled._body(args, plan.reader(), CFG, cap, True, layout)
    return mode.seen


@pytest.mark.parametrize("path", ["volumes", "direct"])
def test_body_dispatches_no_refused_operator(small, path, monkeypatch):
    sc = small["sc"]
    args = compiled._arguments(sc["tcams"], small["sv"], small["prior"],
                               small["vs"] if path == "volumes" else None,
                               torch.tensor(0.00875), small["imgs"], small["dms"], CFG)
    seen = refused_operators(monkeypatch, args, sc["H"], sc["W"], small["cap"])
    assert seen == set(), seen


def _refuse(*args, **kwargs):
    raise AssertionError("the compiled pass was called")


def test_profile_stages_and_trace_pass_call_the_body(monkeypatch, capsys, tmp_path):
    monkeypatch.setattr(pipeline, "patchmatch_pass", _refuse)
    monkeypatch.setattr(profile_stages, "REPEATS", 1)
    row = profile_stages.measure(64, 48, 3, "cpu")
    assert set(row["stages_ms"]) >= {"weak_prep", "strong_black", "weak_sweep"}
    from apdmvs_tpu_torch import bench

    images, depths, normals, cams = bench.flagship_scene(64, 48, 3, "cpu")
    vs, prior, cap, _ = bench.flagship_state(images, depths, normals, cams, K)
    seen = trace_pass.flagship_h6_calls(cams, vs, prior, cap, 0)
    assert {"c36_tent_B10", "c9_tent_B10"} <= set(seen)
    trace_pass.trace_flagship(str(tmp_path), 3, device="cpu", width=48, height=32, views=3)
    out = capsys.readouterr().out
    assert "flagship_apd_pass: wall" in out and (tmp_path / "flagship_apd_pass.json").exists()


def test_run_scene_profile_dir_runs_the_body(monkeypatch, tmp_path):
    """A traced scene calls the body by name; an untraced one the compiled
    entry (one FIRST_INIT pass over two views)."""
    from apdmvs_tpu_torch.datasets import synthetic

    calls = []
    real = pipeline.patchmatch_pass

    def counted(*args, **kwargs):
        calls.append(1)
        return real(*args, **kwargs)

    schedule = scene.build_schedule(1)[:1]
    monkeypatch.setattr(scene, "build_schedule", lambda rounds: schedule)
    monkeypatch.setattr(pipeline, "patchmatch_pass", counted)
    folder = str(tmp_path / "scene")
    cams, planes = synthetic.make_ring_scene(num_views=2, width=48, height=32)
    synthetic.write_mvsnet_dataset(folder, cams, planes, depth_ranges=(2.0, 8.0))
    scene.run_scene(folder, device="cpu", num_slices=16, verbose=False)
    assert len(calls) == 2
    scene.run_scene(folder, device="cpu", num_slices=16, verbose=False,
                    profile_dir=str(tmp_path / "prof"))
    assert len(calls) == 2


class _Props:
    def __init__(self, total_memory):
        self.total_memory = total_memory


@pytest.mark.parametrize("gb, pinned", [(80, 5), (16, 0)])
def test_volume_cache_budget_from_the_cards_memory(monkeypatch, gb, pinned):
    """80 GB pins the five 1280x960 sets of the two-round scene; 16 GB
    pins none; an explicit budget wins over the derived one."""
    monkeypatch.setattr(torch.cuda, "get_device_properties", lambda dev: _Props(gb * 1e9))
    V, H, W = 5, 960, 1280
    per_set = ncc.image_volume_set_nbytes(V, H, W, 160)
    budget = scene.volume_cache_budget("cuda:0", V, H, W, 160)
    assert parallel.pinned_count(per_set, V, budget) == pinned
    assert (V * per_set <= budget) == (pinned == V)  # the scene caches all or none


def test_explicit_volume_cache_budget_wins():
    built = []

    def builder():
        built.append(1)
        return ncc.VolumeSet(E=torch.zeros(256), consts=torch.zeros(1), ref_pad=torch.zeros(1))

    for explicit, builds in ((0.0, 2), (None, 1)):
        built.clear()
        cache = scene.SceneCache(".", volume_cache_bytes=explicit, expected_sets=1)
        for _ in range(2):
            cache.image_volumes(0, 64, builder, budget=1e12)
        assert len(built) == builds
    with pytest.raises(ValueError, match="budget"):
        scene.SceneCache(".").image_volumes(0, 64, builder)
