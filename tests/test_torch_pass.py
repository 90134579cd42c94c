"""The port's slice as a whole: one PatchMatch pass against the reference.

The reference is ``apdmvs_tpu.pipeline.patchmatch_pass`` run with volumes on
the CPU (its kernels route through their exact mirrors there); the port runs
``apdmvs_tpu_torch.pipeline.patchmatch_pass`` on the CPU (plain versions of
its kernels). Both get the same cameras, volumes and prior state (carried
over by convert.py; the volume builds are compared in test_torch_kernels.py)
and the reference's random draws replayed (tests/_torch_parity.py). Cases:
a FIRST_INIT pass and a REFINE_ITER pass with geometric consistency.

Tolerance: ``pixel_state`` / ``selected`` equal on >= 99% of pixels, and
depth within 1e-3 relative on >= 99% of pixels for the geometric pass. The
two sides round differently: the reference's XLA CPU build contracts
``a * b + c`` into fused multiply-adds, vectorises sums at the host's
vector width and computes rsqrt apart from 1/sqrt; the port rounds every
operation as PyTorch does. So costs agree closely, not bit for bit, and a
near-tie in an argmin (which neighbour's plane to adopt, which refinement
combo wins) may pick another, nearly equal plane, which propagation then
spreads. A FIRST_INIT pass, started from random planes, has many such
near-ties. The reference is as sensitive to its own rounding: compiled for
plain AVX (``XLA_FLAGS=--xla_cpu_max_isa=AVX``: no fused multiply-add,
narrower vectors) it agrees with its default build on fewer of the depths
within 1e-3 than the port does (printed by the test below; 98.75% against
99.18% at this seed). So the FIRST_INIT pass is held to >= 98% within 1e-3
and >= 99% within 1e-2, and
``test_first_init_pass_agrees_as_well_as_reference_with_itself`` holds the
port to at least the reference's agreement with its own AVX build.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import DMAX, DMIN, JaxDraws, ring_scene, t
from apdmvs_tpu import ncc as jncc, pipeline as jpipe
from apdmvs_tpu.params import PassConfig, PixelState, RunState
from apdmvs_tpu_torch import convert, ncc as tncc, pipeline as tpipe
from apdmvs_tpu_torch.ops import ncc_volume as tnv

torch.set_num_threads(2)

K = 64
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _compare(jout, tout, rel_tol=1e-3):
    jd = np.asarray(jout.depth)
    td = tout.depth.numpy()
    rel = np.abs(td - jd) / np.maximum(np.abs(jd), 1e-6)
    depth_ok = np.mean(rel < rel_tol)
    state_ok = np.mean(np.asarray(jout.pixel_state) == tout.pixel_state.numpy())
    sel_ok = np.mean(np.all(np.asarray(jout.selected) == tout.selected.numpy(), axis=0))
    return depth_ok, state_ok, sel_ok


def _reference_first_init(seed=3):
    """The scene, its volumes and the reference's FIRST_INIT pass."""
    sc = ring_scene(num_views=3, width=128, height=40)
    V, H, W = sc["V"], sc["H"], sc["W"]
    images = sc["images"]
    src_valid = np.array([False] + [True] * (V - 1))
    jvs = jncc.build_image_volume_set(jnp.asarray(images), sc["jcams"], DMIN, DMAX,
                                      num_slices=K, weak_cost_volumes=False)
    prior = jpipe.PassState(
        depth=jnp.zeros((H, W)), normal_world=jnp.zeros((H, W, 3)),
        pixel_state=jnp.full((H, W), PixelState.STRONG, jnp.uint8),
        selected=jnp.zeros((V, H, W), bool),
    )
    cfg = PassConfig(state=RunState.FIRST_INIT, geom_consistency=False, use_APD=False,
                     max_iterations=3, weak_peak_radius=6)
    key = jax.random.PRNGKey(seed)
    jout = jpipe.patchmatch_pass(jnp.asarray(images), sc["jcams"], jnp.asarray(src_valid),
                                 prior, key, cfg, jnp.asarray(0.005), volumes=jvs)
    return sc, src_valid, jvs, prior, cfg, key, jout


@pytest.fixture(scope="module")
def first_init():
    sc, src_valid, jvs, prior, cfg, key, jout = _reference_first_init()
    tvs = convert.to_volume_set(jvs)
    tprior = convert.to_pass_state(prior)
    tout = tpipe.patchmatch_pass(convert.to_cameras(sc["jcams"]), t(src_valid), tprior,
                                 JaxDraws(key, sc["H"], sc["W"]), cfg, tvs)
    return sc, jvs, tvs, jout, tout


def test_first_init_pass_matches_reference(first_init):
    _, _, _, jout, tout = first_init
    depth_ok, state_ok, sel_ok = _compare(jout, tout)
    assert depth_ok >= 0.98, depth_ok
    assert _compare(jout, tout, rel_tol=1e-2)[0] >= 0.99
    assert state_ok >= 0.99, state_ok
    assert sel_ok >= 0.99, sel_ok


def test_first_init_pass_agrees_as_well_as_reference_with_itself(first_init, tmp_path):
    """The reference's FIRST_INIT pass, rebuilt for plain AVX in a fresh
    process (no fused multiply-add, narrower vectors), differs from its
    default build by rounding alone; the port must agree with the default
    build at least as well as that."""
    _, _, _, jout, tout = first_init
    out = tmp_path / "depth_avx.npy"
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=ROOT,
               XLA_FLAGS=os.environ.get("XLA_FLAGS", "") + " --xla_cpu_max_isa=AVX")
    subprocess.run([sys.executable, os.path.abspath(__file__), str(out)], cwd=ROOT, env=env,
                   check=True, timeout=300)
    jd = np.asarray(jout.depth)
    self_ok = np.mean(np.abs(np.load(out) - jd) / np.maximum(np.abs(jd), 1e-6) < 1e-3)
    depth_ok = _compare(jout, tout)[0]
    print(f"FIRST_INIT depths within 1e-3: port vs reference {depth_ok:.6f}, "
          f"reference AVX build vs default build {self_ok:.6f}")
    assert self_ok < 1.0, "the AVX build did not change the reference's rounding"
    assert depth_ok >= self_ok, (depth_ok, self_ok)


def test_refine_iter_geom_pass_matches_reference(first_init):
    sc, jvs, tvs, jout0, _ = first_init
    V, H, W = sc["V"], sc["H"], sc["W"]
    images, depths = sc["images"], sc["depths"]
    src_valid = np.array([False] + [True] * (V - 1))
    # prior: the reference's FIRST_INIT output, fed to both sides
    prior = jpipe.PassState(depth=jout0.depth, normal_world=jout0.normal_world,
                            pixel_state=jout0.pixel_state, selected=jout0.selected)
    cfg = PassConfig(state=RunState.REFINE_ITER, geom_consistency=True, use_APD=False,
                     max_iterations=3, weak_peak_radius=4)
    jvs_g = jncc.add_depth_volumes(jvs, jnp.asarray(depths), sc["jcams"], DMIN, DMAX)
    tvs_g = convert.to_volume_set(jvs_g)
    key = jax.random.PRNGKey(4)
    jout = jpipe.patchmatch_pass(jnp.asarray(images), sc["jcams"], jnp.asarray(src_valid),
                                 prior, key, cfg, jnp.asarray(0.005),
                                 depth_maps=jnp.asarray(depths), volumes=jvs_g)
    tprior = convert.to_pass_state(prior)
    tout = tpipe.patchmatch_pass(convert.to_cameras(sc["jcams"]), t(src_valid), tprior,
                                 JaxDraws(key, H, W), cfg, tvs_g)
    depth_ok, state_ok, sel_ok = _compare(jout, tout)
    assert depth_ok >= 0.99, depth_ok
    assert state_ok >= 0.99, state_ok
    assert sel_ok >= 0.99, sel_ok
    # and the pass did its job on this oracle scene
    gt = depths[0]
    m = np.zeros_like(gt, bool)
    m[8:-8, 10:-10] = gt[8:-8, 10:-10] > 0
    assert np.median(np.abs(tout.depth.numpy() - gt)[m] / gt[m]) < 0.01


def test_refine_init_pass_without_apd_matches_reference(first_init):
    """A REFINE_INIT pass with the weak machinery off: the runners take this
    branch when a pass of round 1 or later finds no WEAK pixel
    (``apdmvs_tpu_torch/scene.py``, ``weak_capacity == 0``: use_APD off,
    ``apdmvs_tpu/scene.py:388-393``). Prior: the reference's FIRST_INIT
    output; the tolerances of the geometric pass above."""
    sc, jvs, tvs, jout0, _ = first_init
    V, H, W = sc["V"], sc["H"], sc["W"]
    src_valid = np.array([False] + [True] * (V - 1))
    prior = jpipe.PassState(depth=jout0.depth, normal_world=jout0.normal_world,
                            pixel_state=jout0.pixel_state, selected=jout0.selected)
    cfg = PassConfig(state=RunState.REFINE_INIT, geom_consistency=False, use_APD=False,
                     max_iterations=3, weak_peak_radius=6)
    key = jax.random.PRNGKey(7)
    jout = jpipe.patchmatch_pass(jnp.asarray(sc["images"]), sc["jcams"], jnp.asarray(src_valid),
                                 prior, key, cfg, jnp.asarray(0.00875), volumes=jvs)
    tout = tpipe.patchmatch_pass(convert.to_cameras(sc["jcams"]), t(src_valid),
                                 convert.to_pass_state(prior), JaxDraws(key, H, W), cfg, tvs,
                                 ransac_threshold=0.00875)
    depth_ok, state_ok, sel_ok = _compare(jout, tout)
    print(f"REFINE_INIT without APD: depths within 1e-3 {depth_ok:.6f}, pixel_state equal "
          f"{state_ok:.6f}, selected equal {sel_ok:.6f}")
    assert depth_ok >= 0.99, depth_ok
    assert state_ok >= 0.99, state_ok
    assert sel_ok >= 0.99, sel_ok
    # the prior carried WEAK pixels, which this pass leaves to the strong sweeps
    assert (np.asarray(prior.pixel_state) == PixelState.WEAK).any()


def test_refine_iter_pass_reads_e_alone(first_init, monkeypatch):
    """A REFINE_ITER pass builds no rebased volume (the reference rebases
    on the recost and every iteration) and evaluates every NCC cost over
    all source views at once, never one view at a time."""
    sc, _, tvs, _, tout0 = first_init
    calls = {"build_rebased_view": 0, "ncc_cost": 0, "ncc_cost_views": 0}

    def spy(name):
        fn = getattr(tnv, name)

        def counted(*args, **kwargs):
            calls[name] += 1
            return fn(*args, **kwargs)
        return counted

    for name in calls:
        monkeypatch.setattr(tnv, name, spy(name))
    V, H, W = sc["V"], sc["H"], sc["W"]
    prior = tpipe.PassState(depth=tout0.depth, normal_world=tout0.normal_world,
                            pixel_state=tout0.pixel_state, selected=tout0.selected)
    cfg = PassConfig(state=RunState.REFINE_ITER, geom_consistency=False, use_APD=False,
                     max_iterations=3, weak_peak_radius=4)
    out = tpipe.patchmatch_pass(convert.to_cameras(sc["jcams"]), t(np.arange(V) > 0), prior,
                                JaxDraws(jax.random.PRNGKey(5), H, W), cfg, tvs)
    assert calls["build_rebased_view"] == 0
    assert calls["ncc_cost"] == 0
    assert calls["ncc_cost_views"] > 0
    assert bool(torch.isfinite(out.depth).all())


def test_refine_iter_geom_pass_evaluates_all_views_at_once(first_init, monkeypatch):
    """A geometric REFINE_ITER pass evaluates every geometric cost over all
    source views in one call, never one view at a time."""
    sc, _, tvs, _, tout0 = first_init
    calls = {"geom_cost_views": 0, "geom_volume_cost_view": 0}

    def spy(name):
        fn = getattr(tnv, name)

        def counted(*args, **kwargs):
            calls[name] += 1
            return fn(*args, **kwargs)
        return counted

    for name in calls:
        monkeypatch.setattr(tnv, name, spy(name))
    V, H, W = sc["V"], sc["H"], sc["W"]
    cams = convert.to_cameras(sc["jcams"])
    tvs_g = tncc.add_depth_volumes(tvs, t(sc["depths"]), cams, DMIN, DMAX)
    prior = tpipe.PassState(depth=tout0.depth, normal_world=tout0.normal_world,
                            pixel_state=tout0.pixel_state, selected=tout0.selected)
    cfg = PassConfig(state=RunState.REFINE_ITER, geom_consistency=True, use_APD=False,
                     max_iterations=3, weak_peak_radius=4)
    out = tpipe.patchmatch_pass(cams, t(np.arange(V) > 0), prior,
                                JaxDraws(jax.random.PRNGKey(6), H, W), cfg, tvs_g)
    assert calls["geom_volume_cost_view"] == 0
    assert calls["geom_cost_views"] > 0
    assert bool(torch.isfinite(out.depth).all())


if __name__ == "__main__":
    # the reference's FIRST_INIT depth map, saved to argv[1] (run with
    # XLA_FLAGS by test_first_init_pass_agrees_as_well_as_reference_with_itself)
    jax.config.update("jax_platforms", "cpu")
    np.save(sys.argv[1], np.asarray(_reference_first_init()[-1].depth))
