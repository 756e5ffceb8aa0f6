# noqa: D400 D205
"""
Carrying region state across from the JAX package
-------------------------------------------------

:func:`region_from_reference` rebuilds the port's transform layer and
region from the arrays of a reference (``ultranest_tpu``) region, given
as numpy, so that both packages filter candidates against the same
region. Nothing here imports the reference: the caller passes its
arrays (see :func:`reference_state`).
"""

import numpy as np

from .mlfriends import (AffineLayer, LocalAffineLayer, MLFriends,
                        RobustEllipsoidRegion, ScalingLayer, SimpleRegion,
                        WrappingEllipsoid)

__all__ = ['reference_state', 'region_from_reference', 'live_from_state']

_LAYERS = {'ScalingLayer': ScalingLayer, 'AffineLayer': AffineLayer,
           'LocalAffineLayer': LocalAffineLayer}
_REGIONS = {'MLFriends': MLFriends,
            'RobustEllipsoidRegion': RobustEllipsoidRegion,
            'SimpleRegion': SimpleRegion,
            'WrappingEllipsoid': WrappingEllipsoid}
_REGION_ARRAYS = ('u', 'unormed', 'maxradiussq', 'enlarge',
                  'ellipsoid_center', 'ellipsoid_invcov',
                  'ellipsoid_axes_T', 'ellipsoid_cov', 'bbox_lo', 'bbox_hi',
                  'variable_dims')
_LAYER_ARRAYS = ('T', 'invT', 'ctr', 'mean', 'std', 'clusterids',
                 'nclusters', 'logvolscale', 'wrapped_dims')


def reference_state(region, live_L=None):
    """Plain dict of numpy arrays describing a reference region.

    Works on any object with the reference's attribute names; a
    ``WrappingEllipsoid`` has no transform layer.
    """
    state = dict(region=type(region).__name__)
    for name in _REGION_ARRAYS:
        if hasattr(region, name) and getattr(region, name) is not None:
            state[name] = np.asarray(getattr(region, name))
    layer = getattr(region, 'transformLayer', None)
    if layer is not None:
        state['layer'] = type(layer).__name__
        for name in _LAYER_ARRAYS:
            if hasattr(layer, name) and getattr(layer, name) is not None:
                state['layer_' + name] = np.asarray(getattr(layer, name))
    if live_L is not None:
        state['live_L'] = np.asarray(live_L)
    return state


def region_from_reference(state, device):
    """Build the port's region (and its layer) from :func:`reference_state`.

    The arrays are copied, not recomputed: the port's region holds the
    reference's ``u``, ``unormed``, whitening ``T``/``invT``/``ctr`` (or
    ``mean``/``std``), radius, enlargement, ellipsoid and bounding box.
    An MLFriends-type region runs its neighbour queries on *device*; a
    ``WrappingEllipsoid`` is host-only and ignores it.
    """
    cls = _REGIONS[state['region']]
    if cls is WrappingEllipsoid:
        region = cls(np.array(state['u'], dtype=float))
        vd = state.get('variable_dims')
        region.variable_dims = Ellipsis if vd is None or vd.ndim == 0 \
            else vd.astype(bool)
        region.enlarge = float(state['enlarge'])
        region.ellipsoid_center = np.array(state['ellipsoid_center'])
        region.ellipsoid_invcov = np.array(state['ellipsoid_invcov'])
        region.ellipsoid_cov = np.array(state['ellipsoid_cov'])
        return region
    layer = _LAYERS[state['layer']](
        wrapped_dims=list(state.get('layer_wrapped_dims', [])))
    for name in _LAYER_ARRAYS:
        key = 'layer_' + name
        if key in state and name != 'wrapped_dims':
            value = np.array(state[key])
            setattr(layer, name, value.item() if value.ndim == 0 else value)
    region = cls(np.array(state['u'], dtype=float), layer, device=device)
    region.unormed = np.array(state['unormed'])
    for name in ('bbox_lo', 'bbox_hi', 'ellipsoid_center',
                 'ellipsoid_invcov', 'ellipsoid_axes_T', 'ellipsoid_cov'):
        if name in state:
            setattr(region, name, np.array(state[name]))
    region.maxradiussq = float(state['maxradiussq'])
    region.enlarge = float(state['enlarge'])
    return region


def live_from_state(state):
    """(live_u, live_L) arrays of the region's live points."""
    return np.array(state['u']), np.array(state['live_L'])
