# noqa: D400 D205
"""
Constrained 'billiard' Hamiltonian sampler
------------------------------------------

Dynamic constrained HMC: inside the likelihood constraint the potential
is flat, so trajectories are straight lines; at the constraint surface
the velocity mirrors on the likelihood gradient (a billiard bounce).
Trajectory doubling is *iterative* with reservoir sampling of the
visited valid states (no recursion), and gradients come from
``torch.autograd`` of the user's torch likelihood
(:func:`gradient_from_torch`) instead of user-supplied callbacks.
A copy of ``ultranest_tpu/dychmc.py``, numpy on the host, but for the
gradient.

Experimental family (as in the reference).
"""

import numpy as np
import torch

__all__ = ['gradient_from_torch', 'step_or_reflect', 'stop_criterion',
           'build_tree', 'tree_sample', 'generate_uniform_direction',
           'DynamicCHMCSampler']


def gradient_from_torch(torch_loglike, torch_transform=None, device='cuda'):
    """Unit likelihood-gradient function from a torch log-likelihood.

    Returns ``gradient(u) -> unit vector`` (the inward contour normal) as
    numpy, computed by ``torch.autograd`` in float32 on *device* ('cuda'
    by default; 'cpu' on request): the counterpart of
    ``gradient_from_jax`` (``ultranest_tpu/dychmc.py:25-49``).
    *torch_loglike* and *torch_transform* are batched, (n, d) -> (n,) and
    (n, d) -> (n, params).
    """
    def gradient(u):
        x = torch.tensor(np.asarray(u, float)[None, :], dtype=torch.float32,
                         device=device, requires_grad=True)
        p = torch_transform(x) if torch_transform is not None else x
        g, = torch.autograd.grad(torch_loglike(p)[0], x)
        g = g[0].double().cpu().numpy()
        n = np.linalg.norm(g)
        return g / n if n > 0 else g

    return gradient


def generate_uniform_direction(d, massmatrix=1):
    """Isotropic random unit velocity in *d* dimensions."""
    v = np.random.normal(size=d)
    return v / np.linalg.norm(v)


def step_or_reflect(theta, v, epsilon, transform, loglike, gradient, Lmin):
    """One billiard integration step.

    Advances ``theta`` by ``epsilon * v``; if that lands below the
    likelihood threshold, bounces the velocity off the gradient normal
    at the crossing and retries from the original point.

    Returns ``(theta', v', logl or None, reflected, nc)``.
    """
    nc = 0
    t1 = theta + epsilon * v
    if np.all(t1 > 0) and np.all(t1 < 1):
        L1 = float(loglike(transform(t1.reshape((1, -1))))[0])
        nc += 1
        if L1 > Lmin:
            return t1, v, L1, False, nc
        n = gradient(t1)
    else:
        # cube wall: reflect on the wall normal(s)
        n = np.zeros(len(theta))
        n[t1 <= 0] = 1.0
        n[t1 >= 1] = -1.0
        n /= np.linalg.norm(n)
    vr = v - 2 * (v @ n) * n
    t2 = theta + epsilon * vr
    if np.all(t2 > 0) and np.all(t2 < 1):
        L2 = float(loglike(transform(t2.reshape((1, -1))))[0])
        nc += 1
        if L2 > Lmin:
            return t2, vr, L2, True, nc
    # stuck: reverse
    return theta, -v, None, True, nc


def stop_criterion(thetaminus, thetaplus, rminus, rplus):
    """No-U-Turn test: both ends still travel apart."""
    span = thetaplus - thetaminus
    return (span @ rminus) >= 0 and (span @ rplus) >= 0


def build_tree(state, direction, nsteps, epsilon, transform, loglike,
               gradient, Lmin, rng=np.random):
    """Extend one trajectory end by *nsteps* billiard steps.

    *state* is ``(theta, v)`` of that end. Returns the advanced end
    state, the list of visited valid points ``[(theta, L), ...]``, the
    call count, and whether the end got stuck (reversed twice).
    """
    theta, v = state
    visited = []
    nc = 0
    stuck = 0
    for _ in range(nsteps):
        theta, v, L, reflected, dnc = step_or_reflect(
            theta, direction * v, epsilon, transform, loglike, gradient,
            Lmin)
        v = direction * v
        nc += dnc
        if L is None:
            stuck += 1
            if stuck >= 2:
                break
        else:
            visited.append((theta, L))
    return (theta, v), visited, nc, stuck >= 2


def tree_sample(theta0, L0, v0, epsilon, transform, loglike, gradient,
                Lmin, max_doublings=6, rng=np.random):
    """Iterative doubling with reservoir sampling of valid states.

    The trajectory grows by doubling (randomly forwards or backwards);
    every valid visited state enters a uniform reservoir. Expansion
    stops on a U-turn between the two trajectory ends or when both ends
    are stuck.

    Returns ``(theta, L, nc)``.
    """
    fwd = (theta0.copy(), v0.copy())
    rwd = (theta0.copy(), -v0.copy())
    reservoir = (theta0, L0)
    nvalid = 1
    nc = 0
    blocklen = 1
    for _ in range(max_doublings):
        go_fwd = rng.uniform() < 0.5
        end = fwd if go_fwd else rwd
        end, visited, dnc, dead = build_tree(
            end, 1.0, blocklen, epsilon, transform, loglike, gradient,
            Lmin, rng)
        if go_fwd:
            fwd = end
        else:
            rwd = end
        nc += dnc
        for (th, L) in visited:
            nvalid += 1
            if rng.uniform() < 1.0 / nvalid:
                reservoir = (th, L)
        blocklen *= 2
        if dead:
            break
        if not stop_criterion(rwd[0], fwd[0], -rwd[1], fwd[1]):
            break
    theta, L = reservoir
    return theta, L, nc


class DynamicCHMCSampler:
    """Step sampler: chains of billiard trajectories above the contour.

    Parameters
    ----------
    scale: float
        integration step size (adapted towards few reflections)
    nsteps: int
        trajectories per chain until the sample counts as independent
    adaptive_nsteps: False or str
        accepted for API compatibility (no nsteps adaptation here)
    delta: float
        target fraction of reflected steps for scale adaptation
    nudge: float
        multiplicative scale adaptation factor
    """

    def __init__(self, scale, nsteps, adaptive_nsteps=False, delta=0.9,
                 nudge=1.04):
        """Set up with integration step *scale* and *nsteps* per chain."""
        self.scale = float(scale)
        self.nsteps = nsteps
        # kept for the calibrator's clone (no nsteps adaptation here)
        self.adaptive_nsteps = adaptive_nsteps
        self.delta = delta
        self.nudge = nudge
        self.gradient = None
        self.nrejects = 0
        self.logstat = []
        self.logstat_labels = ['acceptance_rate', 'scale']

    def __str__(self):
        """Short description."""
        return 'DynamicCHMCSampler(scale=%g, nsteps=%d)' % (self.scale,
                                                            self.nsteps)

    def set_gradient(self, gradient):
        """Install the likelihood-gradient function."""
        self.gradient = gradient

    def region_changed(self, Ls, region):
        """No-op: trajectories use only the gradient and the cube."""
        pass

    def plot(self, filename=None):
        """Statistics plotting stub (see ``logstat``)."""
        pass

    def __next__(self, region, Lmin, us, Ls, transform, loglike, ndraw=10,
                 plot=False, tregion=None, log=False):
        """Run one full chain; returns ``(u, p, L, nc)``."""
        assert self.gradient is not None, \
            'call set_gradient() before sampling'
        i = np.random.randint(len(us))
        theta, L = us[i].copy(), Ls[i]
        nc = 0
        moved = 0
        for _ in range(self.nsteps):
            v = generate_uniform_direction(len(theta)) * self.scale
            theta_new, L_new, dnc = tree_sample(
                theta, L, v, 1.0, transform, loglike, self.gradient, Lmin)
            nc += dnc
            if not np.array_equal(theta_new, theta):
                moved += 1
            theta, L = theta_new, L_new
        accept = moved / max(self.nsteps, 1)
        self.logstat.append([accept, self.scale])
        if accept < self.delta:
            self.scale /= self.nudge
        else:
            self.scale *= self.nudge ** 0.25
        if accept == 0:
            self.nrejects += 1
            return None, None, None, nc
        p = transform(theta.reshape((1, -1)))
        return theta, p[0], L, nc
