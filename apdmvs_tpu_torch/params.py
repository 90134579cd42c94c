"""Run configuration: parameters, problems, and the multi-scale schedule.

Mirrors the reference config surface (reference: main.h:75-106) and the
hardcoded coarse-to-fine round scheduler (reference: main.cpp:164-217), but as
plain Python dataclasses consumed by jitted stage programs. Every field that
feeds a jitted function is either baked in as a static argument (shapes,
booleans, iteration counts) or passed as a scalar array (thresholds).
"""

from __future__ import annotations

import dataclasses
import enum
import math
from typing import List, Optional, Sequence, Tuple


class RunState(enum.IntEnum):
    """Pass kind (reference: main.h:63-67)."""

    FIRST_INIT = 0
    REFINE_INIT = 1
    REFINE_ITER = 2


class PixelState(enum.IntEnum):
    """Per-pixel texture classification (reference: main.h:69-73)."""

    WEAK = 0
    STRONG = 1
    UNKNOWN = 2


# Reference constants (main.h:37-39).
MAX_IMAGES = 32
NEIGHBOUR_NUM = 9  # anchor slots per weak pixel: self + 8 anchors
MAX_SEARCH_RADIUS = 4096


@dataclasses.dataclass
class PatchMatchParams:
    """All tunables with reference defaults (reference: main.h:75-94).

    ``sigma_spatial``/``sigma_color`` are kept for config parity but are
    vestigial: the reference hardcodes ``weight = 1.0`` in every NCC loop
    (reference: APD.cu:473,575), making "bilateral" NCC unweighted. We
    implement the effective (unweighted) behavior.
    """

    max_iterations: int = 3
    num_images: int = 5  # overwritten per problem: 1 + len(src_ids)
    sigma_spatial: float = 5.0
    sigma_color: float = 3.0
    top_k: int = 4
    depth_min: float = 0.0
    depth_max: float = 1.0
    geom_consistency: bool = False
    strong_radius: int = 5
    strong_increment: int = 2
    weak_radius: int = 5
    weak_increment: int = 5
    use_APD: bool = True
    weak_peak_radius: int = 2
    rotate_time: int = 4
    ransac_threshold: float = 0.005
    geom_factor: float = 0.2
    state: RunState = RunState.FIRST_INIT


@dataclasses.dataclass
class Problem:
    """One (reference view, pass) work item (reference: main.h:96-106)."""

    index: int
    ref_image_id: int
    src_image_ids: List[int]
    dense_folder: str = ""
    result_folder: str = ""
    scale_size: int = 1
    params: PatchMatchParams = dataclasses.field(default_factory=PatchMatchParams)
    show_medium_result: bool = False
    iteration: int = 0


def compute_round_num(width: int, height: int) -> int:
    """Number of pyramid rounds: halve max dim until <= 1000
    (reference: main.cpp:72-88)."""
    max_size = max(width, height)
    round_num = 1
    while max_size > 1000:
        max_size //= 2
        round_num += 1
    return round_num


@dataclasses.dataclass(frozen=True)
class PassSpec:
    """Fully-resolved parameters for one scheduled pass over all views."""

    round_index: int
    pass_index: int  # global pass counter ("iteration" in reference)
    scale_size: int
    state: RunState
    use_APD: bool
    geom_consistency: bool
    max_iterations: int
    weak_peak_radius: int
    ransac_threshold: float
    rotate_time: int


def build_schedule(round_num: int) -> List[PassSpec]:
    """The exact coarse-to-fine schedule (reference: main.cpp:164-217).

    Per round i: one init pass (A) then three refine passes (B x3):
      - scale_size = 2^(round_num-1-i)
      - pass A: FIRST_INIT/use_APD=False when i==0 else REFINE_INIT/use_APD=True
        with ransac_threshold = 0.01 - i*0.00125, rotate_time = min(2^i, 4);
        geom_consistency=False, weak_peak_radius=6.
      - passes B j=0..2: REFINE_ITER, geom_consistency=True,
        weak_peak_radius = max(4-2j, 2); same use_APD/ransac/rotate rule.
    """
    schedule: List[PassSpec] = []
    pass_index = 0
    for i in range(round_num):
        scale_size = 2 ** (round_num - 1 - i)
        if i == 0:
            state, use_apd = RunState.FIRST_INIT, False
            ransac_threshold, rotate_time = 0.005, 4  # defaults, unused
        else:
            state, use_apd = RunState.REFINE_INIT, True
            ransac_threshold = 0.01 - i * 0.00125
            rotate_time = min(2 ** i, 4)
        schedule.append(
            PassSpec(
                round_index=i,
                pass_index=pass_index,
                scale_size=scale_size,
                state=state,
                use_APD=use_apd,
                geom_consistency=False,
                max_iterations=3,
                weak_peak_radius=6,
                ransac_threshold=ransac_threshold,
                rotate_time=rotate_time,
            )
        )
        pass_index += 1
        for j in range(3):
            if i == 0:
                use_apd_b = False
                ransac_threshold_b, rotate_time_b = 0.005, 4
            else:
                use_apd_b = True
                ransac_threshold_b = 0.01 - i * 0.00125
                rotate_time_b = min(2 ** i, 4)
            schedule.append(
                PassSpec(
                    round_index=i,
                    pass_index=pass_index,
                    scale_size=scale_size,
                    state=RunState.REFINE_ITER,
                    use_APD=use_apd_b,
                    geom_consistency=True,
                    max_iterations=3,
                    weak_peak_radius=max(4 - 2 * j, 2),
                    ransac_threshold=ransac_threshold_b,
                    rotate_time=rotate_time_b,
                )
            )
            pass_index += 1
    return schedule


@dataclasses.dataclass(frozen=True)
class PassConfig:
    """Static (hashable) configuration compiled into the jitted pass program.

    Everything here changes compilation (shapes or control flow); dynamic
    scalars (ransac_threshold, depth ranges) are passed as arrays instead.
    """

    state: RunState
    geom_consistency: bool
    use_APD: bool
    max_iterations: int = 3
    weak_peak_radius: int = 6
    rotate_time: int = 4
    top_k: int = 4
    strong_radius: int = 5
    strong_increment: int = 2
    weak_radius: int = 5
    weak_increment: int = 5
    geom_factor: float = 0.2
    num_mc_samples: int = 15

    @classmethod
    def from_spec(cls, spec: "PassSpec") -> "PassConfig":
        return cls(
            state=spec.state,
            geom_consistency=spec.geom_consistency,
            use_APD=spec.use_APD,
            max_iterations=spec.max_iterations,
            weak_peak_radius=spec.weak_peak_radius,
            rotate_time=spec.rotate_time,
        )


def scaled_size(width: int, height: int, scale_size: int) -> Tuple[int, int]:
    """Image size at a pyramid level (reference: APD.cpp:464-471)."""
    if scale_size == 1:
        return width, height
    factor = 1.0 / float(scale_size)
    return int(round(width * factor)), int(round(height * factor))
