"""Antenna array layout generators and presets.

Accelerator-first rebuild of the reference's layout machinery
(hexagon/rectangle/circular generators at
/root/reference/prisim/interferometry.py:857-1183, presets + perturbations at
:1686-1860). All host-side float64 numpy — this runs once per simulation.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

__all__ = [
    "ArrayLayout", "hexagon_generator", "rectangle_generator",
    "circular_antenna_array", "preset_layout", "parse_layout_file",
    "PRESET_LAYOUTS",
]


@dataclass
class ArrayLayout:
    """Antenna positions in local ENU coordinates with labels/ids."""
    positions: np.ndarray          # (nant, 3) float64, meters, ENU
    labels: np.ndarray             # (nant,) str
    ids: np.ndarray = None         # (nant,) int
    coords: str = "ENU"

    def __post_init__(self):
        self.positions = np.atleast_2d(np.asarray(self.positions,
                                                  dtype=np.float64))
        if self.positions.shape[1] == 2:
            self.positions = np.hstack(
                [self.positions, np.zeros((self.positions.shape[0], 1))])
        self.labels = np.asarray(self.labels, dtype=str)
        if self.ids is None:
            self.ids = np.arange(self.positions.shape[0])
        self.ids = np.asarray(self.ids)

    @property
    def nant(self):
        return self.positions.shape[0]

    def perturbed(self, rms_tgtplane=0.0, rms_elevation=0.0, seed=None):
        """Return a copy with seeded Gaussian position errors
        (cf. /root/reference/prisim/interferometry.py:1856-1862)."""
        rng = np.random.RandomState(seed)
        de = rms_tgtplane / np.sqrt(2.0) * rng.randn(self.nant)
        dn = rms_tgtplane / np.sqrt(2.0) * rng.randn(self.nant)
        du = rms_elevation * rng.randn(self.nant)
        pos = self.positions + np.stack([de, dn, du], axis=-1)
        return ArrayLayout(pos, self.labels.copy(), self.ids.copy(),
                           self.coords)


def hexagon_generator(spacing, n_total=None, n_side=None, orientation=None,
                      center=None):
    """Antenna positions filling a regular hexagon (HERA-style).

    n_total must satisfy n_total = 3*n_side^2 - 3*n_side + 1.
    Returns (positions (N,2), labels).
    """
    if (n_total is None) == (n_side is None):
        raise ValueError("specify exactly one of n_total / n_side")
    if n_side is None:
        # invert n = 3 s^2 - 3 s + 1
        s = (3 + np.sqrt(9 - 12 * (1 - n_total))) / 6.0
        n_side = int(np.round(s))
        if 3 * n_side ** 2 - 3 * n_side + 1 != n_total:
            raise ValueError(f"{n_total} is not a centered hexagonal number")
    n_total = 3 * n_side ** 2 - 3 * n_side + 1

    xs, ys = [], []
    # Rows above/below the center line: row i (1..n_side-1) has 2*n_side-1-i
    # antennas offset by i/2 in x and i*sqrt(3)/2 in y.
    for i in range(1, n_side):
        x = np.arange(2 * n_side - 1 - i) + i * 0.5
        y = i * (np.sqrt(3.0) / 2.0)
        xs += [x, x]
        ys += [np.full(x.size, y), np.full(x.size, -y)]
    x0 = np.arange(2 * n_side - 1, dtype=np.float64)
    xs.append(x0)
    ys.append(np.zeros(x0.size))
    xy = np.stack([np.concatenate(xs), np.concatenate(ys)], axis=-1)
    assert xy.shape[0] == n_total
    xy = xy - xy.mean(axis=0, keepdims=True)
    if orientation is not None:
        a = np.radians(orientation)
        rot = np.array([[np.cos(a), -np.sin(a)], [np.sin(a), np.cos(a)]])
        xy = xy @ rot.T
    xy = xy * spacing
    if center is not None:
        xy = xy + np.asarray(center).reshape(1, 2)
    labels = [str(i) for i in range(n_total)]
    return xy, labels


def rectangle_generator(spacing, n_side, orientation=None, center=None):
    """Rectangular grid of antennas (PAPER/HIRAX/CHIME style)."""
    spacing = np.atleast_1d(np.asarray(spacing, dtype=np.float64))
    if spacing.size == 1:
        spacing = np.repeat(spacing, 2)
    n_side = np.atleast_1d(np.asarray(n_side, dtype=np.int64))
    if n_side.size == 1:
        n_side = np.repeat(n_side, 2)
    nx, ny = int(n_side[0]), int(n_side[1])
    xv, yv = np.meshgrid(np.arange(nx) * spacing[0],
                         np.arange(ny) * spacing[1], indexing="ij")
    xy = np.stack([xv.ravel(), yv.ravel()], axis=-1)
    xy = xy - xy.mean(axis=0, keepdims=True)
    if orientation is not None:
        a = np.radians(orientation)
        rot = np.array([[np.cos(a), -np.sin(a)], [np.sin(a), np.cos(a)]])
        xy = xy @ rot.T
    if center is not None:
        xy = xy + np.asarray(center).reshape(1, 2)
    labels = [str(i) for i in range(xy.shape[0])]
    return xy, labels


def circular_antenna_array(element_size, minR, maxR=None, seed=None):
    """Ring(s) of antennas between radii minR..maxR with ~element_size
    packing (cf. /root/reference/prisim/interferometry.py:1107-1183)."""
    if maxR is None or maxR <= minR:
        radii = np.asarray([minR], dtype=np.float64)
    else:
        nr = max(1, int(np.floor((maxR - minR) / element_size)) + 1)
        radii = np.linspace(minR, maxR, nr)
    rng = np.random.RandomState(seed)
    xs, ys = [], []
    for r in radii:
        n_on_ring = max(1, int(np.floor(2 * np.pi * r / element_size)))
        phase0 = rng.uniform(0, 2 * np.pi) if seed is not None else 0.0
        ang = phase0 + 2 * np.pi * np.arange(n_on_ring) / n_on_ring
        xs.append(r * np.cos(ang))
        ys.append(r * np.sin(ang))
    xy = np.stack([np.concatenate(xs), np.concatenate(ys)], axis=-1)
    labels = [str(i) for i in range(xy.shape[0])]
    return xy, labels


def _hera(n):
    return lambda: hexagon_generator(14.6, n_total=n)


PRESET_LAYOUTS = {
    "HERA-7": _hera(7), "HERA-19": _hera(19), "HERA-37": _hera(37),
    "HERA-61": _hera(61), "HERA-91": _hera(91), "HERA-127": _hera(127),
    "HERA-169": _hera(169), "HERA-217": _hera(217), "HERA-271": _hera(271),
    "HERA-331": _hera(331),
    "PAPER-64": lambda: rectangle_generator([30.0, 4.0], [8, 8]),
    "PAPER-112": lambda: rectangle_generator([15.0, 4.0], [16, 7]),
    "HIRAX-1024": lambda: rectangle_generator(7.0, n_side=32),
    "CHIME": lambda: rectangle_generator([20.0, 0.3], [5, 256]),
}


def preset_layout(name, minR=None, maxR=None, element_size=None):
    """Construct an ArrayLayout from a named preset
    (cf. /root/reference/prisim/interferometry.py:1792-1851)."""
    if name == "CIRC":
        xy, labels = circular_antenna_array(element_size or 14.0,
                                            minR or 141.0, maxR=maxR)
    elif name in PRESET_LAYOUTS:
        xy, labels = PRESET_LAYOUTS[name]()
    else:
        raise ValueError(f"unknown preset layout {name!r}; known: "
                         f"{sorted(PRESET_LAYOUTS) + ['CIRC']}")
    return ArrayLayout(xy, labels)


def parse_layout_file(path, comment="#", label_col=0, east_col=1,
                      north_col=2, up_col=3, skip_rows=0):
    """Parse a whitespace/comma-delimited antenna layout text file with
    columns (label, east, north, up) — the generic version of the
    MWA/GMRT coordinate-file readers
    (/root/reference/prisim/interferometry.py:1704-1790)."""
    labels, east, north, up = [], [], [], []
    with open(path) as f:
        rows = [ln.strip() for ln in f if ln.strip()
                and not ln.strip().startswith(comment)]
    for ln in rows[skip_rows:]:
        parts = ln.replace(",", " ").split()
        ncol = len(parts)
        labels.append(parts[label_col])
        east.append(float(parts[east_col]))
        north.append(float(parts[north_col]))
        up.append(float(parts[up_col]) if up_col < ncol else 0.0)
    pos = np.stack([east, north, up], axis=-1)
    return ArrayLayout(pos, np.asarray(labels))
