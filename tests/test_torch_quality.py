"""The port's quality table (``python -m apdmvs_tpu_torch.quality_table``).

Fast: each family's scene is the one scripts/quality_table.py and
tests/test_quality.py run (renders and inputs bit-equal), the floors are
tests/test_quality.py's, and the table prints the round-4 F1 of
BASELINE.md beside the port's. Slow (marked ``slow``, like
tests/test_quality.py: a whole scene through the pipeline on the CPU takes
minutes): every family through the port's ``run_scene`` on the CPU, held
to those floors."""

import json
import os
import sys

import numpy as np
import pytest

from apdmvs_tpu.datasets import synthetic as jsyn
from apdmvs_tpu_torch import quality_table as qt
from apdmvs_tpu_torch import scene

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_family(name):
    """scripts/quality_table.py's configuration of a family."""
    if name == "multiround":
        return jsyn.make_ring_scene(num_views=4, width=128, height=96,
                                    include_flat_region=True), False, {"min_rounds": 2}
    if name == "occlusion":
        return jsyn.make_occlusion_scene(num_views=4), True, {}
    if name == "curved":
        return jsyn.make_curved_scene(num_views=4), True, {}
    return jsyn.make_ring_scene(num_views=4, width=160, height=120), True, {}


@pytest.mark.parametrize("family", qt.FAMILIES)
def test_family_is_the_jax_package_s(family):
    cams, prims, noise, run_kw = qt.family_scene(family)
    (jcams, jprims), jnoise, jkw = _jax_family(family)
    assert (noise, run_kw) == (jnoise, jkw)
    images = qt.synthetic.render_scene(cams, prims)
    jimages = jsyn.render_scene(jcams, jprims)
    for a, b in zip(images, jimages):
        np.testing.assert_array_equal(a, b)
    if noise:
        np.testing.assert_array_equal(qt.synthetic.perturb_radiometric(images[0], seed=11),
                                      jsyn.perturb_radiometric(jimages[0], seed=11))


def test_floors_and_round4_are_the_recorded_ones():
    # tests/test_quality.py's floors, BASELINE.md's round-4 F1 (JAX package on a TPU)
    assert qt.FLOORS == {"multiround": (1500, 0.90, 0.78), "occlusion": (3000, 0.81, 0.54),
                         "curved": (3000, 0.89, 0.72), "ring": (3000, 0.90, 0.81)}
    assert qt.ROUND4_F1 == {"multiround": 0.871, "occlusion": 0.572, "curved": 0.798,
                            "ring": 0.902}
    with open(os.path.join(ROOT, "BASELINE.md")) as f:
        base = f.read()
    for fam, f1 in qt.ROUND4_F1.items():
        assert any(ln.startswith(f"| {fam} |") and ln.rstrip().endswith(f"| {f1} |")
                   for ln in base.splitlines()), fam


def test_below_floors_and_markdown():
    row = {"family": "ring", "points": 3001, "accuracy": 0.95, "completeness": 0.8,
           "f1": 0.81, "round4_f1": 0.902}
    assert qt.below_floors(row) == ["f1 0.81 <= 0.81"]
    assert qt.below_floors(dict(row, f1=0.9)) == []
    assert qt.below_floors(dict(row, points=3000, accuracy=0.5, f1=0.9)) == [
        "points 3000 <= 3000", "accuracy 0.5 <= 0.9"]
    md = qt.markdown([dict(row, f1=0.9)], "NVIDIA H100 80GB HBM3, 700.00 W").splitlines()
    assert md[0].startswith("| Scene family |") and "JAX package on a TPU" in md[0]
    assert md[2] == "| ring | 3001 | 0.9500 | 0.8000 | 0.9000 | 0.902 |"


def test_refuses_without_a_card_and_unknown_families(monkeypatch, tmp_path):
    import torch

    with pytest.raises(ValueError, match="unknown family"):
        qt.run_family("sphere", str(tmp_path), "cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(sys, "argv", ["quality_table", "--families", "ring"])
    with pytest.raises(RuntimeError, match="cuda"):
        qt.main()
    with pytest.raises(RuntimeError, match="cuda"):
        scene.resolve_device("cuda")


@pytest.mark.slow
@pytest.mark.parametrize("family", qt.FAMILIES)
def test_port_quality_on_the_cpu(family, capsys):
    """The port's counterpart of tests/test_quality.py, with its floors."""
    qt.main(["--device", "cpu", "--families", family])
    last = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    (row,) = last["families"]
    assert row["family"] == family
    assert qt.below_floors(row) == [], row
