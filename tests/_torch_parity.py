"""Shared fixtures of the port's parity tests (tests/test_torch_*.py).

Both implementations get the same inputs as numpy arrays: a small synthetic
ring scene, its cameras, and — for the stochastic stages — the same random
draws. :class:`JaxDraws` is a draw source for the port (see
``apdmvs_tpu_torch/rng.py``) that walks the reference package's key tree
with ``jax.random``, so the port consumes exactly the numbers the reference
pass draws from the same key (``pipeline.py:93,165-166``,
``propagation.py:173-174,252``, ``hypotheses.py:91,116``, and for the weak
machinery ``weak.py:425,451,487,518,576,936,975,1015``).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import torch

from apdmvs_tpu import geometry as jgeom
from apdmvs_tpu.datasets import synthetic
from apdmvs_tpu_torch import geometry as tgeom

DMIN, DMAX = 2.0 * 0.6, 8.0 * 1.2  # ref depth range x 0.6 / 1.2 (APD.cpp:454-455)


def ring_scene(num_views=3, width=128, height=48, include_flat_region=False):
    cams, planes = synthetic.make_ring_scene(num_views=num_views, width=width, height=height,
                                             include_flat_region=include_flat_region)
    images, depths, normals = synthetic.render_scene(cams, planes)
    K = np.stack([c.K for c in cams]).astype(np.float32)
    R = np.stack([c.R for c in cams]).astype(np.float32)
    t = np.stack([c.t for c in cams]).astype(np.float32)
    V = len(cams)
    dmin = np.full(V, DMIN, np.float32)
    dmax = np.full(V, DMAX, np.float32)
    jc = jgeom.make_cameras(K, R, t, dmin, dmax)
    tc = tgeom.make_cameras(K, R, t, dmin, dmax)
    return dict(cams=cams, planes=planes, images=images, depths=depths, normals=normals,
                jcams=jc, tcams=tc, V=V, H=height, W=width)


def flat_ring_scene(num_views=3, width=128, height=96):
    """The ring scene with its textureless window (the weak machinery's
    test scene) and its cameras at the pass's depth range."""
    sc = ring_scene(num_views, width, height, include_flat_region=True)
    sc["flat"] = np.abs(sc["images"][0] - 128.0) < 1e-3
    return sc


def t(a, dtype=None):
    """numpy / jax array -> CPU tensor."""
    out = torch.from_numpy(np.array(a))
    return out if dtype is None else out.to(dtype)


def off_by_one(x: torch.Tensor) -> torch.Tensor:
    """``x`` copied into a buffer one element past its start: a contiguous
    tensor whose data is not 16-byte aligned."""
    buf = torch.empty(x.numel() + 1, dtype=x.dtype)
    buf[1:] = x.reshape(-1)
    return buf[1:].view(x.shape)


class JaxDraws:
    """Port draw source replaying the reference pass's draws from ``key``."""

    def __init__(self, key, height: int, width: int, num_samples: int = 15):
        self.shape = (height, width)
        self.num_samples = num_samples
        self.k_init, k_anchor, self.k_iters = jax.random.split(key, 3)
        self.k_probe, self.k_ransac = jax.random.split(k_anchor)

    def init_plane(self):
        kd, kn = jax.random.split(self.k_init)
        return (t(jax.random.uniform(kd, self.shape, jnp.float32, 0.0, 1.0)),
                t(jax.random.normal(kn, self.shape + (3,), jnp.float32)))

    def _color_key(self, it, color):
        k_it = jax.random.fold_in(self.k_iters, it)
        return jax.random.split(k_it, 3)[color]

    def view_selection(self, it, color):
        k_mc, _ = jax.random.split(self._color_key(it, color))
        keys = jax.random.split(k_mc, self.num_samples)
        return t(jax.vmap(lambda k: jax.random.uniform(k, self.shape))(keys))

    def refinement(self, it, color):
        _, k_ref = jax.random.split(self._color_key(it, color))
        return _refinement_draws(k_ref, self.shape)

    # the weak machinery's draws (weak.py)

    def anchor_probes(self, steps, dirs, shift_range):
        keys = jax.random.split(self.k_probe, steps)
        return t(jnp.stack([jax.random.randint(k, (dirs, 2), -shift_range + 1, shift_range)
                            for k in keys]))

    def anchor_ransac(self, shape):
        return _ransac_draws(self.k_ransac, shape)

    def _weak_keys(self, it):
        return jax.random.split(self._color_key(it, 2), 3)  # k_fit, k_mc, k_ref

    def fit_ransac(self, it, shape):
        return _ransac_draws(self._weak_keys(it)[0], shape)

    def weak_view_selection(self, it, n):
        keys = jax.random.split(self._weak_keys(it)[1], self.num_samples)
        return t(jax.vmap(lambda k: jax.random.uniform(k, (n,)))(keys))

    def weak_refinement(self, it, n):
        return _refinement_draws(self._weak_keys(it)[2], (n,))


def _refinement_draws(k_ref, shape):
    kd, kn, kp, ke = jax.random.split(k_ref, 4)
    return (t(jax.random.uniform(kd, shape, jnp.float32, 0.0, 1.0)),
            t(jax.random.normal(kn, shape + (3,), jnp.float32)),
            t(jax.random.uniform(kp, shape, jnp.float32)),
            t(jax.random.uniform(ke, shape + (3,))))


def _ransac_draws(key, shape):
    """[steps, N, chunk, 3] triangle draws in [0, 2^30), one key a step."""
    keys = jax.random.split(key, shape[0])
    return t(jnp.stack([jax.random.randint(k, tuple(shape[1:]), 0, 1 << 30) for k in keys]))
