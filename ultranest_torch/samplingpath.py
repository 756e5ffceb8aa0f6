# noqa: D400 D205
"""
Reflected-ray geometry in the unit cube
---------------------------------------

Geometry primitives for trajectory samplers that travel along straight
rays and bounce off the unit-cube walls (and, at a higher level, off
likelihood contours). Functional equivalent of the reference's
`ultranest/samplingpath.py`, redesigned around a closed form: motion
with wall reflections equals the *unfolded* straight line passed through
a period-2 triangle wave, so any travel time is one vectorized
expression instead of a bounce-by-bounce loop — exact, reversible, and
traceable for batched use.

Conventions: ``x`` is a position in the open unit cube, ``v`` a velocity
(one integer "step" advances ``x`` by ``v``), ``i``/``t`` a (possibly
fractional, possibly negative) number of steps.

A copy of ``ultranest_tpu/samplingpath.py``: numpy on the host.
"""

import numpy as np

__all__ = [
    'nearest_box_intersection_line', 'box_line_intersection',
    'linear_steps_with_reflection', 'get_sphere_tangent',
    'get_sphere_tangents', 'reflect', 'distances', 'isunitlength', 'angle',
    'extrapolate_ahead', 'interpolate', 'SamplingPath',
    'ContourSamplingPath',
]


def _fold(y):
    """Triangle-wave fold of unconstrained coordinates into [0, 1].

    Returns ``(position, orientation)``: the folded coordinate and the
    sign (+1/-1) of the local direction of travel for a coordinate that
    was increasing before folding.
    """
    z = np.mod(y, 2.0)
    descending = z > 1.0
    pos = np.where(descending, 2.0 - z, z)
    return pos, np.where(descending, -1.0, 1.0)


def linear_steps_with_reflection(ray_origin, ray_direction, t,
                                 wrapped_dims=None):
    """Travel *t* steps from *ray_origin*, bouncing off the cube walls.

    Closed form (no bounce loop): the straight line ``x + t v`` is
    folded coordinate-wise by the period-2 triangle wave; the outgoing
    velocity keeps ``|v|`` and flips the sign of every coordinate that
    is currently on a descending branch of the wave.

    Returns ``(position, velocity)`` after the travel. Exactly
    reversible: travelling ``t`` with ``-v_out`` returns to the start.
    """
    x = np.asarray(ray_origin, float)
    v = np.asarray(ray_direction, float)
    if wrapped_dims is not None and np.any(wrapped_dims):
        w = np.asarray(wrapped_dims, bool)
        xw = np.mod(x + t * v, 1.0)
        pos, orient = _fold(x + t * v)
        return np.where(w, xw, pos), np.where(w, v, orient * v)
    pos, orient = _fold(x + t * v)
    return pos, orient * v


def nearest_box_intersection_line(ray_origin, ray_direction, fwd=True):
    """First unit-cube wall hit by the ray (forward or backward).

    Returns ``(crossing_point, travel_steps, wall_axes)`` where
    *wall_axes* lists every coordinate axis whose wall is reached at
    that same travel time (usually one; several at corners).
    """
    x = np.asarray(ray_origin, float)
    v = np.asarray(ray_direction, float)
    with np.errstate(divide='ignore', invalid='ignore'):
        # per-axis times to the 0-wall and the 1-wall
        t0 = -x / v
        t1 = (1.0 - x) / v
    t_exit = np.where(v != 0, np.maximum(t0, t1), np.inf)
    t_enter = np.where(v != 0, np.minimum(t0, t1), -np.inf)
    if fwd:
        t = t_exit.min()
        axes = np.flatnonzero(t_exit == t)
    else:
        t = t_enter.max()
        axes = np.flatnonzero(t_enter == t)
    p = x + t * v
    # the hit coordinates lie exactly on a wall; snap away the round-off
    p[axes] = np.round(p[axes])
    return p, t, axes


def box_line_intersection(ray_origin, ray_direction):
    """Both unit-cube crossings of the infinite line through the ray.

    Returns ``((p_near, t_near, axes_near), (p_far, t_far, axes_far))``
    with the backward (negative-step) crossing first.
    """
    near = nearest_box_intersection_line(ray_origin, ray_direction,
                                         fwd=False)
    far = nearest_box_intersection_line(ray_origin, ray_direction, fwd=True)
    return near, far


def reflect(v, normal):
    """Mirror velocity *v* on the plane with unit *normal*."""
    return v - 2.0 * (v @ normal) * normal


def get_sphere_tangent(sphere_center, edge_point):
    """Inward unit normal of a sphere surface at *edge_point*."""
    d = np.asarray(sphere_center, float) - np.asarray(edge_point, float)
    return d / np.linalg.norm(d)


def get_sphere_tangents(sphere_center, edge_point):
    """Row-wise :func:`get_sphere_tangent` for point arrays."""
    d = np.asarray(sphere_center, float) - np.asarray(edge_point, float)
    return d / np.linalg.norm(d, axis=1, keepdims=True)


def distances(direction, center, r=1):
    """Travel times where the ray from the origin crosses a sphere.

    Solves ``|t*direction - center| = r`` for unit *direction*.
    Returns the two roots ``(t_in, t_out)``; NaNs when the ray misses.
    """
    b = direction @ center
    disc = b * b - (center @ center - r * r)
    if disc < 0:
        return np.nan, np.nan
    s = disc ** 0.5
    return b - s, b + s


def isunitlength(vec):
    """Assert that *vec* has euclidean length 1."""
    assert np.isclose(np.linalg.norm(vec), 1.0), np.linalg.norm(vec)


def angle(a, b):
    """Cosine between two vectors (not normalized)."""
    return a @ b


def extrapolate_ahead(dj, xj, vj, contourpath=None):
    """Predict the reflected position *dj* steps from ``(xj, vj)``.

    When a *contourpath* is given, its region spheres also act as
    mirrors: if the straight extension leaves the neighbourhood of the
    live points, the surface normal estimated by the region bends the
    trajectory back (one reflection is applied at the midpoint).
    """
    x1, v1 = linear_steps_with_reflection(xj, vj, dj)
    if contourpath is not None and not contourpath.region.inside(
            x1.reshape((1, -1)))[0]:
        half, vhalf = linear_steps_with_reflection(xj, vj, dj * 0.5)
        normal = contourpath.gradient(half)
        if normal is not None:
            vref = reflect(vhalf, normal)
            x1, v1 = linear_steps_with_reflection(half, vref, dj * 0.5)
    return x1, v1


def interpolate(i, points, fwd_possible, rwd_possible, contourpath=None):
    """Point at integer time *i* on a stored path.

    *points* is a list of ``(index, x, v, L)`` tuples in ascending index
    order. Exact stored indices return their point; indices between
    stored neighbours are linearly interpolated (``onpath=True``);
    indices beyond the stored range are extrapolated with reflections
    (``onpath=False``, no likelihood known).

    Returns ``(x, v, L, onpath)``.
    """
    idx = [p[0] for p in points]
    if i in idx:
        _, x, v, L = points[idx.index(i)]
        return x, v, L, True
    lo = [k for k in idx if k < i]
    hi = [k for k in idx if k > i]
    if lo and hi:
        j0, j1 = max(lo), min(hi)
        _, x0, v0, _ = points[idx.index(j0)]
        _, x1, v1, _ = points[idx.index(j1)]
        f = (i - j0) / (j1 - j0)
        return x0 + f * (x1 - x0), v0, None, True
    if hi:
        j1 = min(hi)
        _, x1, v1, _ = points[idx.index(j1)]
        x, v = extrapolate_ahead(i - j1, x1, v1, contourpath)
        return x, v, None, False
    if lo:
        j0 = max(lo)
        _, x0, v0, _ = points[idx.index(j0)]
        x, v = extrapolate_ahead(i - j0, x0, v0, contourpath)
        return x, v, None, False
    raise KeyError('index %d not reachable on path %s' % (i, idx))


class SamplingPath:
    """Lazily evaluated reflected trajectory through the unit cube.

    Stores the evaluated points ``(i, x, v, L)`` keyed by integer step
    index; in-between and beyond-range queries interpolate/extrapolate.
    """

    def __init__(self, x0, v0, L0):
        """Start a path at ``x0`` with velocity ``v0`` and likelihood ``L0``."""
        self.reset(x0, v0, L0)

    def reset(self, x0, v0, L0):
        """Restart: forget all points except the new starting point."""
        self.points = [(0, np.asarray(x0, float), np.asarray(v0, float),
                        L0)]
        self.fwd_possible = True
        self.rwd_possible = True

    def add(self, i, xi, vi, Li):
        """Record the evaluated point at step index *i*."""
        self.points.append((i, np.asarray(xi, float),
                            np.asarray(vi, float), Li))
        self.points.sort(key=lambda p: p[0])

    @property
    def ilo(self):
        """Lowest stored step index."""
        return self.points[0][0]

    @property
    def ihi(self):
        """Highest stored step index."""
        return self.points[-1][0]

    def interpolate(self, i):
        """Return ``(x, v, L, onpath)`` at step index *i*."""
        return interpolate(i, self.points, self.fwd_possible,
                           self.rwd_possible)

    def extrapolate(self, i):
        """Predict ``(x, v)`` beyond the stored range with reflections."""
        if i > self.ihi:
            j, x, v, _ = self.points[-1]
        else:
            j, x, v, _ = self.points[0]
        return linear_steps_with_reflection(x, v, i - j)

    def plot(self, **kwargs):
        """Draw the stored path segment (matplotlib)."""
        import matplotlib.pyplot as plt
        xs = np.array([p[1] for p in self.points])
        plt.plot(xs[:, 0], xs[:, 1], 'o-', **kwargs)


class ContourSamplingPath:
    """A :class:`SamplingPath` aware of the live-point region geometry.

    Provides the likelihood-contour normal estimate used for
    reflections: the direction from the query point towards the
    mass of its nearest live points in whitened space.
    """

    def __init__(self, samplingpath, region):
        """Wrap *samplingpath*, using *region* for normal estimates."""
        self.samplingpath = samplingpath
        self.region = region
        self.points = samplingpath.points

    def add(self, i, x, v, L):
        """Record an evaluated point on the underlying path."""
        self.samplingpath.add(i, x, v, L)

    def interpolate(self, i):
        """Return ``(x, v, L, onpath)`` at step index *i*."""
        return interpolate(i, self.samplingpath.points,
                           self.samplingpath.fwd_possible,
                           self.samplingpath.rwd_possible,
                           contourpath=self)

    def extrapolate(self, i):
        """Predict ``(x, v)`` beyond the stored range."""
        return self.samplingpath.extrapolate(i)

    def gradient(self, reflpoint, plot=False):
        """Estimate the inward contour normal at *reflpoint*.

        The normal is the unit vector from *reflpoint* towards the mean
        of the k nearest live points in the region's whitened metric —
        a cluster-robust proxy for the likelihood gradient direction
        (the reference derives it from region sphere surfaces instead).
        Returns None if *reflpoint* sits on top of the live points.
        """
        t = self.region.transformLayer.transform(reflpoint)
        tlive = self.region.unormed
        d2 = ((tlive - t) ** 2).sum(axis=1)
        k = min(16, len(tlive))
        nearest = np.argpartition(d2, k - 1)[:k]
        target = self.region.u[nearest].mean(axis=0)
        delta = target - reflpoint
        norm = np.linalg.norm(delta)
        if norm == 0:
            return None
        return delta / norm
