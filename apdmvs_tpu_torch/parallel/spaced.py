"""Space-sharded (row-slab) volume sets.

PyTorch counterpart of ``apdmvs_tpu/parallel/spaced.py:1-71``. The JAX
package registers its mesh in a trace-time registry and stores every pixel
field of a spaced ``VolumeSet`` with a leading [S] axis sharded over the
mesh's 'space' axis. Here a spaced set carries its own geometry: one
ordinary :class:`~apdmvs_tpu_torch.ncc.VolumeSet` per row slab, each on its
own device, and the slab geometry ``(S, Hs, Hp, Wp)``; there is no registry.

Slab ``s`` owns the interior rows ``[s * Hs, (s + 1) * Hs)`` of the padded
image grid (``Hp = S * Hs`` rows, a multiple of ``NCC_TILE_H * S``) and
stores ``PAD_Y`` halo rows on each side, built exactly through the slab's
global row offset ``row0 = s * Hs`` (``ncc.build_volume_set_spaced``), so
the cost kernels run unchanged on each slab and need no halo exchange.
Slab 0 lives on the device of the pass that evaluates the set.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch


class SpacedVolumeSet(NamedTuple):
    """The volumes of one problem as ``S`` row slabs.

    slabs: one ``ncc.VolumeSet`` per slab; slab s's E is
      [V-1, K, Hs + 2*PAD_Y, Wp + 2*PAD_X], its D [V-1, K, Hs, Wp], its
      consts carry ``row0 = s * Hs`` at index 20 (33 for geom_consts:
      index 32); every other constant is the same in every slab.
    Hs: interior rows a slab owns; Hp = S * Hs: the padded image height;
    Wp: the padded image width (a multiple of TILE_W).
    """

    slabs: Tuple
    Hs: int
    Hp: int
    Wp: int

    @property
    def spaced(self) -> bool:
        """True: evaluators route a spaced set to their slab branches
        (``ncc.VolumeSet.spaced`` is False)."""
        return True

    @property
    def S(self) -> int:
        return len(self.slabs)

    @property
    def devices(self) -> Tuple[torch.device, ...]:
        return tuple(sl.E.device for sl in self.slabs)

    @property
    def num_slices(self) -> int:
        return self.slabs[0].num_slices

    @property
    def u_grid(self):
        """(u_min, du) of the slice grid, slab 0's copy (every slab has it)."""
        return self.slabs[0].u_grid

    def slab_rows(self, s: int) -> Tuple[int, int]:
        """The interior rows [start, stop) of the padded grid slab ``s``
        owns."""
        return s * self.Hs, (s + 1) * self.Hs


def slab_owner(ys: torch.Tensor, Hs: int, S: int) -> torch.Tensor:
    """The slab that holds each integer row ``ys`` (any shape): row y lies
    in slab ``y // Hs``; rows above the grid belong to slab 0 and rows
    below it to slab S-1, whose halos coincide with the whole grid's."""
    return torch.clamp(torch.div(ys, Hs, rounding_mode="floor"), 0, S - 1)
