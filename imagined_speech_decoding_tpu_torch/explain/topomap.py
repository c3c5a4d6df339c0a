"""Scalp topographic maps without MNE.

Counterpart of ``imagined_speech_decoding_tpu/explain/topomap.py``.
Electrode positions come from the published 10-10 construction
(Oostenveld & Praamstra 2001) on an idealized spherical head: midline
electrodes along the nasion-inion great circle, the outer ring (Fp1/2,
AF7/8, F7/8, FT7/8, T7/8, TP7/8, P7/8, PO7/8, O1/2) at 10%-arc steps
around the 72-degree-inclination circle, intermediate electrodes by
great-circle interpolation between the row's midline and ring points,
and the 9/10 ring on the 90-degree circle. The 2-D view is the
azimuthal-equidistant projection (radius proportional to the inclination
from Cz, head outline at 90 degrees), so Cz maps to the origin and T7/T8
to (-0.8, 0) and (0.8, 0). Names outside the 10-10 grammar fall back to a
schematic row/chord layout. The positions are numpy; the maps are SciPy
``griddata`` (cubic) masked to the head disk, drawn with matplotlib,
which only the drawing functions import.
"""

from __future__ import annotations

import math
import os
import re
from typing import Dict, Optional, Sequence, Tuple

import numpy as np


def pyplot():
    """``matplotlib.pyplot`` on the file-only Agg backend (raises
    ``ImportError`` without matplotlib)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


# --- standard_1020 idealized-sphere construction -------------------------
#
# Per row: (midline inclination from Cz in deg, front(+1)/back(-1),
# ring azimuth from nasion in deg). The FC/CP rows' lateral ring
# electrodes carry the FT/TP names; T is the C row's ring name.
_ROW_SPEC: Dict[str, Tuple[float, float, float]] = {
    "Fp": (72.0, +1.0, 18.0),
    "AF": (54.0, +1.0, 36.0),
    "F":  (36.0, +1.0, 54.0),
    "FC": (18.0, +1.0, 72.0),
    "FT": (18.0, +1.0, 72.0),
    "C":  (0.0,  +1.0, 90.0),
    "T":  (0.0,  +1.0, 90.0),
    "CP": (18.0, -1.0, 108.0),
    "TP": (18.0, -1.0, 108.0),
    "P":  (36.0, -1.0, 126.0),
    "PO": (54.0, -1.0, 144.0),
    "O":  (72.0, -1.0, 162.0),
}
_RING_THETA = 72.0  # inclination of the 10% ring (deg)

# Front-to-back row coordinate (y, nose at +1) per 10-10 row prefix
# (schematic fallback for names the spherical construction can't place).
_ROW_Y: Dict[str, float] = {
    "Fp": 0.85, "AF": 0.68, "F": 0.50, "FT": 0.28, "FC": 0.25,
    "T": 0.0, "C": 0.0, "TP": -0.28, "CP": -0.25, "P": -0.50,
    "PO": -0.68, "O": -0.85,
}
# Lateral fraction of the row chord per column level (1/2 → innermost).
_COL_FRAC = {1: 0.25, 2: 0.5, 3: 0.75, 4: 1.0, 5: 1.25}

_NAME_RE = re.compile(r"^(Fp|AF|FT|FC|TP|CP|PO|F|T|C|P|O)(z|\d+)$")


def _sphere_point(theta_deg: float, azimuth_deg: float, side: float) -> np.ndarray:
    """Unit vector at inclination theta from Cz, azimuth from nasion
    (side=-1 left / +1 right / 0 midline-front; x right, y front, z up)."""
    th = math.radians(theta_deg)
    az = math.radians(azimuth_deg)
    return np.array(
        [side * math.sin(az) * math.sin(th), math.cos(az) * math.sin(th), math.cos(th)]
    )


def _project(p: np.ndarray) -> Tuple[float, float]:
    """Azimuthal-equidistant 2-D projection: r = inclination / 90 deg."""
    theta = math.acos(max(-1.0, min(1.0, float(p[2]))))
    r = theta / (math.pi / 2)
    h = math.hypot(float(p[0]), float(p[1]))
    if h < 1e-12:
        return 0.0, 0.0
    return r * float(p[0]) / h, r * float(p[1]) / h


def standard_1020_position(name: str) -> Tuple[float, float]:
    """(x, y) of a 10-10 electrode from the idealized-sphere standard
    construction; raises ``ValueError`` for names outside the grammar."""
    m = _NAME_RE.match(name)
    if not m:
        raise ValueError(f"cannot parse electrode name {name!r}")
    row, col = m.group(1), m.group(2)
    theta_m, front, ring_az = _ROW_SPEC[row]
    if col == "z":
        # midline: in the sagittal plane, front or back of Cz
        return _project(_sphere_point(theta_m, 0.0 if front > 0 else 180.0, 0.0))
    n = int(col)
    side = -1.0 if n % 2 == 1 else 1.0  # odd = left
    level = (n + 1) // 2
    ring = _sphere_point(_RING_THETA, ring_az, side)
    if level >= 5:  # 9/10 ring: the 90-deg circle, same azimuth
        return _project(_sphere_point(90.0, ring_az, side))
    if row in ("Fp", "O"):  # Fp1/2, O1/2 ARE ring electrodes (level 1)
        return _project(ring)
    if level == 4:  # 7/8: the ring electrode itself
        return _project(ring)
    # interior: great-circle (slerp) interpolation midline -> ring at
    # quarter-arc steps (1/2 -> 1/4, 3/4 -> 2/4, 5/6 -> 3/4)
    mid = _sphere_point(theta_m, 0.0 if front > 0 else 180.0, 0.0)
    omega = math.acos(max(-1.0, min(1.0, float(np.dot(mid, ring)))))
    t = level / 4.0
    p = (
        math.sin((1 - t) * omega) * mid + math.sin(t * omega) * ring
    ) / math.sin(omega)
    return _project(p)


def schematic_position(name: str) -> Tuple[float, float]:
    """Schematic (x, y) fallback layout, head radius 1."""
    m = _NAME_RE.match(name)
    if not m:
        raise ValueError(f"cannot parse electrode name {name!r}")
    row, col = m.group(1), m.group(2)
    y = _ROW_Y[row]
    chord = math.sqrt(max(1.0 - y * y, 0.05))
    if col == "z":
        return 0.0, y
    n = int(col)
    side = -1.0 if n % 2 == 1 else 1.0  # odd = left
    level = (n + 1) // 2
    if row in ("T",):  # T7/T8 sit on the circle at the central row
        frac = 1.0
    elif row in ("FT", "TP") and level <= 4:
        frac = 1.0  # FT7/8, TP7/8 on the circle
    else:
        frac = _COL_FRAC.get(level, 1.25)
    x = side * chord * min(frac, 1.25)
    if level == 5:  # 9/10 ring lies below/outside the head circle
        r = math.hypot(x, y)
        x, y = x / r * 1.12, y / r * 1.12
    return x, y


def electrode_position(name: str) -> Tuple[float, float]:
    """(x, y) position of an electrode, head radius 1: the standard_1020
    spherical construction when the name fits the 10-10 grammar, the
    schematic layout otherwise."""
    try:
        return standard_1020_position(name)
    except (ValueError, KeyError):
        return schematic_position(name)


def montage_positions(names: Sequence[str]) -> np.ndarray:
    """(N, 2) positions for a list of electrode names."""
    return np.array([electrode_position(n) for n in names])


def plot_topomap(
    values: np.ndarray,  # (C,)
    names: Sequence[str],
    ax=None,
    cmap: str = "RdBu_r",
    vlim: Optional[Tuple[float, float]] = None,
    contours: int = 6,
    show_names: bool = False,
    title: str = "",
):
    """Render one scalp map on ``ax`` (a new figure's if None); returns
    ``(ax, image)``."""
    from scipy.interpolate import griddata

    plt = pyplot()
    pos = montage_positions(names)
    if ax is None:
        _, ax = plt.subplots(figsize=(4, 4))
    if vlim is None:
        m = float(np.nanmax(np.abs(values))) or 1.0
        vlim = (-m, m)

    grid = np.linspace(-1.15, 1.15, 128)
    gx, gy = np.meshgrid(grid, grid)
    gz = griddata(pos, np.asarray(values, float), (gx, gy), method="cubic")
    mask = gx**2 + gy**2 > 1.0
    gz = np.where(mask, np.nan, gz)

    im = ax.imshow(
        gz, extent=(-1.15, 1.15, -1.15, 1.15), origin="lower",
        cmap=cmap, vmin=vlim[0], vmax=vlim[1],
    )
    if contours:
        with np.errstate(invalid="ignore"):
            try:
                ax.contour(gx, gy, gz, contours, colors="k", linewidths=0.3, alpha=0.4)
            except Exception:
                pass  # flat maps have no contour levels

    # head outline + nose + ears
    theta = np.linspace(0, 2 * np.pi, 100)
    ax.plot(np.cos(theta), np.sin(theta), "k", lw=1.5)
    ax.plot([-0.08, 0, 0.08], [0.99, 1.12, 0.99], "k", lw=1.5)
    for s in (-1, 1):
        ear_t = np.linspace(-0.4, 0.4, 20)
        ax.plot(s * (1.0 + 0.04 * np.cos(ear_t * np.pi)), ear_t * 0.35, "k", lw=1.0)

    ax.scatter(pos[:, 0], pos[:, 1], s=6, c="k", zorder=3)
    if show_names:
        for (x, y), n in zip(pos, names):
            ax.annotate(n, (x, y), fontsize=5, ha="center", va="bottom")
    ax.set_xlim(-1.25, 1.25)
    ax.set_ylim(-1.25, 1.25)
    ax.set_aspect("equal")
    ax.axis("off")
    if title:
        ax.set_title(title, fontsize=10)
    return ax, im


def save_topomap(path: str, values: np.ndarray, names: Sequence[str], title: str = "", **kw) -> str:
    plt = pyplot()
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    fig, ax = plt.subplots(figsize=(4.5, 4))
    _, im = plot_topomap(values, names, ax=ax, title=title, **kw)
    fig.colorbar(im, ax=ax, shrink=0.7)
    fig.tight_layout()
    fig.savefig(path, dpi=120)
    plt.close(fig)
    return path
