"""The compiled pass over row slabs (``apdmvs_tpu_torch/compiled.py`` with
a ``parallel.SpacedVolumeSet``) and its routing, on the CPU.

A CUDA graph needs a card, so the tests hold what its capture rests on, at
the sizes of ``tests/test_torch_compiled.py`` (whose fixtures they reuse:
the 48x32x3 ring scene with a textureless window, K = 32, a WEAK block):

- the static key of a spaced set on the pass's device separates S, the
  slab height and the volumes present, and maps two problems that differ
  only in cameras, prior, ``ransac_threshold`` and volume contents to one
  key; a set with a slab on another device (``meta``) raises, naming
  ``patchmatch_pass_impl`` and ROADMAP queue 1 item 4;
- ``compiled._body`` on filled slots of an S = 2 and an S = 3 set (its
  third slab holds no image row) equals the body on the originals and the
  unsharded body, bit for bit, fed the JAX package's draws
  (``JaxDraws``), on a FIRST_INIT pass and a REFINE_ITER pass with
  geometric consistency and APD. The unsharded body is held against the
  JAX pass by ``tests/test_torch_pass.py`` and
  ``tests/test_torch_weak_pass.py``; ``tests/test_torch_spaced.py`` holds
  the slabs against the JAX package's spaced build;
- the spaced body dispatches none of the operators a capture refuses
  (``tests/test_torch_compiled.py::_Refused``);
- routing: ``parallel.sharded._pass_fn`` and ``bench.flagship_pass`` take
  the compiled pass for one device and in a run of two processes
  (``multihost.world_size`` monkeypatched), the body for slabs on two
  devices;
- ``scene.volume_cache_budget`` splits a card among the processes that
  share it (``torch.cuda.device_count``, its memory and
  ``multihost.world_size`` monkeypatched).

Tolerance: bit for bit (``torch.equal``) wherever a pass is compared.
"""

import dataclasses

import jax
import pytest
import torch

from _torch_parity import JaxDraws
from apdmvs_tpu_torch import bench, compiled, ncc, pipeline, rng, scene
from apdmvs_tpu_torch.parallel import multihost, sharded
from apdmvs_tpu_torch.params import PassConfig, RunState
from test_torch_compiled import CFG, DMAX, DMIN, K, _Props, refused_operators, small  # noqa: F401

torch.set_num_threads(2)

FIRST = PassConfig(state=RunState.FIRST_INIT, geom_consistency=False, use_APD=False,
                   max_iterations=2)
CFGS = {"FIRST_INIT": FIRST, "REFINE_ITER geom APD": CFG}


def _spaced(small, S, cfg, device="cpu"):
    sc = small["sc"]
    return ncc.build_volume_set_spaced(
        small["imgs"], sc["tcams"], DMIN, DMAX, [device] * S, num_slices=K,
        depth_maps=small["dms"] if cfg.geom_consistency else None,
        weak_cost_volumes=cfg.use_APD)


def _unsharded(small, cfg):
    sc = small["sc"]
    vs = ncc.build_image_volume_set(small["imgs"], sc["tcams"], DMIN, DMAX, K,
                                    weak_cost_volumes=cfg.use_APD)
    return (ncc.add_depth_volumes(vs, small["dms"], sc["tcams"], DMIN, DMAX)
            if cfg.geom_consistency else vs)


def _key(small, vs, cfg=CFG, **over):
    kw = dict(cams=small["sc"]["tcams"], prior=small["prior"], cfg=cfg, volumes=vs,
              weak_capacity=small["cap"], debug=False)
    kw.update(over)
    return compiled.static_key(**kw)


def _on_meta(vs):
    return type(vs)(*(None if f is None else f.to("meta") for f in vs))


def test_spaced_static_key(small):
    sc = small["sc"]
    sp2 = _spaced(small, 2, CFG)
    key = _key(small, sp2)
    assert key[4][:5] == ("spaced", 2, sp2.Hs, sp2.Hp, sp2.Wp)
    # a second problem: other cameras, prior, threshold and volume contents
    sp2b = sp2._replace(slabs=tuple(sl._replace(E=sl.E + 1, D=sl.D * 2, C9=sl.C9 - 1)
                                    for sl in sp2.slabs))
    assert _key(small, sp2b, cams=sc["tcams"]._replace(K=sc["tcams"].K * 1.01),
                prior=small["prior"]._replace(depth=small["prior"].depth + 1.0)) == key
    sp3 = _spaced(small, 3, CFG)
    tall = _spaced(small, 2, CFG)
    tall = tall._replace(Hs=tall.Hs + 16, Hp=tall.Hp + 32)  # another slab height
    others = [
        _key(small, sp3),
        _key(small, tall),
        _key(small, sp2._replace(slabs=tuple(sl._replace(C36=None, C9=None)
                                             for sl in sp2.slabs))),
        _key(small, sp2._replace(slabs=tuple(sl._replace(D=None, geom_consts=None)
                                             for sl in sp2.slabs))),
        _key(small, _unsharded(small, CFG)),
    ]
    assert sp3.Hs == sp2.Hs and sp3.Hp != sp2.Hp
    assert len({key, *others}) == len(others) + 1


def test_spaced_set_over_two_devices_raises(small):
    sp = _spaced(small, 2, CFG)
    spread = sp._replace(slabs=(sp.slabs[0], _on_meta(sp.slabs[1])))
    with pytest.raises(ValueError, match="queue 1 item 4") as err:
        _key(small, spread)
    assert "patchmatch_pass_impl" in str(err.value)


@pytest.mark.parametrize("cfg_name", list(CFGS))
@pytest.mark.parametrize("S", [2, 3])
def test_spaced_body_on_filled_slots_equals_originals_and_unsharded(small, S, cfg_name):
    """The slots of an S-slab set, filled from the originals, give the
    body's results on the originals and the unsharded body's, bit for bit,
    with the JAX package's draws."""
    cfg = CFGS[cfg_name]
    sc = small["sc"]
    H, W = sc["H"], sc["W"]
    prior = small["prior"]
    if cfg.state == RunState.FIRST_INIT:
        prior = scene._empty_prior(sc["V"], H, W, "cpu")
    sp = _spaced(small, S, cfg)
    key = _key(small, sp, cfg=cfg, prior=prior)
    layout = compiled._layout(key)
    assert layout == (S, sp.Hs, sp.Hp, sp.Wp)
    args = compiled._arguments(sc["tcams"], small["sv"], prior, sp, 0.00875, None, None, cfg)
    assert {r for r in args if r.startswith("volumes.")} == {
        f"volumes.slabs.{s}.{f}" for s in range(S) for f in ncc.VolumeSet._fields
        if getattr(sp.slabs[s], f) is not None}
    slots = compiled._DeviceGraphs().input_slots(args, "cpu")
    assert all(slots[role] is not v for role, v in args.items())

    def body(a, lay):
        return compiled._body(a, JaxDraws(jax.random.PRNGKey(11), H, W), cfg, small["cap"],
                              False, lay)

    want = body(args, layout)
    for name, got in (("slots", body(slots, layout)),
                      ("unsharded", body(compiled._arguments(
                          sc["tcams"], small["sv"], prior, _unsharded(small, cfg), 0.00875,
                          None, None, cfg), None))):
        for field, x, y in zip(want._fields, got, want):
            assert torch.equal(x, y), (name, field)


def test_spaced_body_dispatches_no_refused_operator(small, monkeypatch):
    sc = small["sc"]
    sp = _spaced(small, 2, CFG)
    args = compiled._arguments(sc["tcams"], small["sv"], small["prior"], sp,
                               torch.tensor(0.00875), None, None, CFG)
    seen = refused_operators(monkeypatch, args, sc["H"], sc["W"], small["cap"],
                             layout=compiled._layout(_key(small, sp)))
    assert seen == set(), seen


def test_pass_routing(small, monkeypatch):
    """The compiled pass for one device and in a run of two processes, the
    body for slabs on two distinct devices: ``_pass_fn`` and
    ``bench.flagship_pass``."""
    cpu, meta = torch.device("cpu"), torch.device("meta")
    called = []
    monkeypatch.setattr(pipeline, "patchmatch_pass", lambda *a, **k: called.append("compiled"))
    monkeypatch.setattr(pipeline, "patchmatch_pass_impl", lambda *a, **k: called.append("body"))
    sp = _spaced(small, 2, CFG)
    spread = sp._replace(slabs=(sp.slabs[0], _on_meta(sp.slabs[1])))
    for world in (1, 2):
        monkeypatch.setattr(multihost, "world_size", lambda: world)
        assert sharded._pass_fn() is pipeline.patchmatch_pass
        assert sharded._pass_fn([cpu]) is pipeline.patchmatch_pass
        assert sharded._pass_fn([cpu, cpu]) is pipeline.patchmatch_pass
        assert sharded._pass_fn([cpu, meta]) is pipeline.patchmatch_pass_impl
        called.clear()
        for vs in (_unsharded(small, CFG), sp, spread):
            bench.flagship_pass(small["sc"]["tcams"], vs, small["prior"], small["cap"], 0)
        bench.flagship_pass(small["sc"]["tcams"], sp, small["prior"], small["cap"], 0,
                            eager=True)
        assert called == ["compiled", "compiled", "body", "body"], world


@pytest.mark.parametrize("cards, world, share", [(1, 1, 1), (1, 2, 2), (2, 2, 1), (2, 3, 2),
                                                 (4, 8, 2)])
def test_volume_cache_budget_splits_a_shared_card(monkeypatch, cards, world, share):
    """Processes that share a card split its memory, and each holds back
    its own pass and compiled share; one process a card keeps the whole
    card's budget; the CPU's budget does not depend on the processes."""
    gb = 80
    args = ("cuda:0", 5, 960, 1280, 160)
    monkeypatch.setattr(torch.cuda, "get_device_properties", lambda dev: _Props(gb * 1e9))
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    monkeypatch.setattr(multihost, "world_size", lambda: 1)
    alone = scene.volume_cache_budget(*args)
    cpu = scene.volume_cache_budget("cpu", *args[1:])
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda dev: _Props(gb * 1e9 / share))
    want = scene.volume_cache_budget(*args)
    monkeypatch.setattr(torch.cuda, "get_device_properties", lambda dev: _Props(gb * 1e9))
    monkeypatch.setattr(multihost, "world_size", lambda: world)
    got = scene.volume_cache_budget(*args)
    assert got == want and (got == alone) == (share == 1) and got > 0
    assert scene.volume_cache_budget("cpu", *args[1:]) == cpu
