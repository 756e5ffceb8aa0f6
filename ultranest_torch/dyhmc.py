# noqa: D400 D205
"""
Dynamic Hamiltonian sampler on a flattened likelihood surface
-------------------------------------------------------------

Constrained sampling via HMC on an auxiliary potential that is ~flat
above the likelihood threshold and rises smoothly below it (a soft
wall), so standard leapfrog dynamics explore the constrained region;
points below the threshold are rejected exactly at the end. Functional
equivalent of the reference's `ultranest/dyhmc.py`, redesigned: the
trajectory is built by *iterative* doubling with progressive
multinomial state sampling (the modern NUTS formulation, no recursion),
and the gradient comes from ``torch.autograd`` via
:func:`transform_loglike_gradient_from_torch`. A copy of
``ultranest_tpu/dyhmc.py``, numpy on the host, but for the gradient.

Experimental family (as in the reference).
"""

import numpy as np
import torch

__all__ = [
    'transform_loglike_gradient_from_torch', 'stop_criterion', 'leapfrog',
    'build_tree', 'tree_sample', 'find_beta_params_static',
    'find_beta_params_dynamic', 'generate_momentum_normal',
    'generate_momentum', 'generate_momentum_circle',
    'generate_momentum_flattened', 'FlattenedProblem', 'DynamicHMCSampler',
]


def transform_loglike_gradient_from_torch(torch_loglike, torch_transform=None,
                                          device='cuda'):
    """Build ``f(u) -> (p, logl, dlogl/du)`` by automatic differentiation.

    ``torch.autograd`` in float32 on *device* ('cuda' by default; 'cpu'
    on request); *p* and the gradient come back as numpy, *logl* as a
    float. The counterpart of ``transform_loglike_gradient_from_jax``
    (``ultranest_tpu/dyhmc.py:30-54``); *torch_loglike* and
    *torch_transform* are batched.
    """
    def f(u):
        x = torch.tensor(np.asarray(u, float)[None, :], dtype=torch.float32,
                         device=device, requires_grad=True)
        p = torch_transform(x) if torch_transform is not None else x
        L = torch_loglike(p)[0]
        g, = torch.autograd.grad(L, x)
        return p[0].detach().double().cpu().numpy(), float(L.detach()), \
            g[0].double().cpu().numpy()

    return f


def stop_criterion(thetaminus, thetaplus, rminus, rplus):
    """No-U-Turn test: both ends still travel apart."""
    span = thetaplus - thetaminus
    return (span @ rminus) >= 0 and (span @ rplus) >= 0


def leapfrog(theta, r, grad, epsilon, invmassmatrix, f):
    """One velocity-Verlet step of the auxiliary dynamics.

    Returns ``(theta', r', grad', logp', extra')`` where *extra* is
    whatever payload *f* attaches (the flattened problem returns the
    raw likelihood there).
    """
    r1 = r + 0.5 * epsilon * grad
    theta1 = theta + epsilon * (invmassmatrix @ r1
                                if np.ndim(invmassmatrix) == 2
                                else invmassmatrix * r1)
    logp1, grad1, extra1 = f(theta1)
    r2 = r1 + 0.5 * epsilon * grad1
    return theta1, r2, grad1, logp1, extra1


def _kinetic(r, invmassmatrix):
    if np.ndim(invmassmatrix) == 2:
        return 0.5 * (r @ invmassmatrix @ r)
    return 0.5 * ((r * r) * invmassmatrix).sum()


def build_tree(end, direction, nsteps, epsilon, invmassmatrix, f, joint0,
               rng=np.random):
    """Advance one trajectory end by *nsteps* leapfrog steps.

    Collects per-state multinomial weights ``exp(joint - joint0)``.
    Returns the new end, the visited states with weights, the call
    count and a divergence flag.
    """
    theta, r, grad = end
    visited = []
    nc = 0
    diverged = False
    for _ in range(nsteps):
        theta, r, grad, logp, extra = leapfrog(
            theta, direction * r, grad, epsilon, invmassmatrix, f)
        r = direction * r
        nc += 1
        joint = logp - _kinetic(r, invmassmatrix)
        if joint - joint0 < -50:
            diverged = True
            break
        visited.append((theta, extra, np.exp(min(joint - joint0, 0.0)),
                        r.copy()))
    return (theta, r, grad), visited, nc, diverged


def tree_sample(theta0, logp0, r0, grad0, extra0, epsilon, invmassmatrix,
                f, max_doublings=8, rng=np.random):
    """Iterative progressive-sampling NUTS trajectory.

    Doubles the trajectory in random directions, reservoir-sampling the
    next state with probability proportional to its joint weight; stops
    on U-turn or divergence.

    Returns ``(theta, extra, accepted, nc)``.
    """
    joint0 = logp0 - _kinetic(r0, invmassmatrix)
    fwd = (theta0.copy(), r0.copy(), grad0.copy())
    rwd = (theta0.copy(), -r0.copy(), grad0.copy())
    sample = (theta0, extra0)
    wtotal = 1.0
    accepted = False
    nc = 0
    blocklen = 1
    for _ in range(max_doublings):
        go_fwd = rng.uniform() < 0.5
        end = fwd if go_fwd else rwd
        end, visited, dnc, diverged = build_tree(
            end, 1.0 if go_fwd else 1.0, blocklen, epsilon, invmassmatrix,
            f, joint0, rng)
        if go_fwd:
            fwd = end
        else:
            rwd = end
        nc += dnc
        for (th, extra, w, _r) in visited:
            wtotal += w
            if rng.uniform() < w / wtotal:
                sample = (th, extra)
                accepted = True
        blocklen *= 2
        if diverged:
            break
        if not stop_criterion(rwd[0], fwd[0], -rwd[1], fwd[1]):
            break
    theta, extra = sample
    return theta, extra, accepted, nc


def find_beta_params_static(d, u10):
    """Beta-shape parameters so that 10% of momenta exceed *u10* (static)."""
    beta = 1.0
    alpha = max(1e-3, np.log(0.9) / np.log(1 - u10 ** (2.0 / d)))
    return alpha, beta


def find_beta_params_dynamic(d, u10):
    """Beta-shape parameters for the dynamic-trajectory variant."""
    alpha, beta = find_beta_params_static(d, u10)
    return alpha, 2.0


def generate_momentum_normal(d, massmatrix):
    """Gaussian momentum draw."""
    if np.ndim(massmatrix) == 2:
        return np.random.multivariate_normal(np.zeros(d), massmatrix)
    return np.random.normal(size=d) * np.sqrt(massmatrix)


def generate_momentum_circle(d, massmatrix):
    """Unit-magnitude momentum draw (direction only)."""
    r = np.random.normal(size=d)
    r /= np.linalg.norm(r)
    if np.ndim(massmatrix) == 2:
        scale = np.sqrt(np.trace(massmatrix) / d)
    else:
        scale = np.sqrt(np.mean(massmatrix))
    return r * scale * np.sqrt(d)


def generate_momentum(d, massmatrix, alpha, beta):
    """Momentum with Beta-distributed magnitude (heavy-tail control)."""
    r = np.random.normal(size=d)
    r /= np.linalg.norm(r)
    mag = np.random.beta(alpha, beta) ** (1.0 / 2)
    return r * mag * np.sqrt(d)


def generate_momentum_flattened(d, massmatrix):
    """Momentum suited to the flattened surface (unit chi magnitude)."""
    return generate_momentum_circle(d, massmatrix)


class FlattenedProblem:
    """Auxiliary smooth potential above a likelihood threshold.

    ``logp(u) = -softplus((Lmin - L(u)) / width)``: approximately 0
    (flat) above the threshold and linearly decreasing below — a soft
    wall that leapfrog dynamics can integrate stably, unlike the hard
    constraint. Final samples are filtered by the exact constraint.
    """

    def __init__(self, Lmin, transform_loglike_gradient, width=None):
        """Flatten around threshold *Lmin*.

        *width* is the wall softness in log-likelihood units (default:
        1).
        """
        self.Lmin = Lmin
        self.tlg = transform_loglike_gradient
        self.width = 1.0 if width is None else width
        self.ncalls = 0

    def __call__(self, u):
        """Return ``(logp_aux, grad_aux, L)`` at *u*."""
        self.ncalls += 1
        p, L, g = self.tlg(u)
        z = (self.Lmin - L) / self.width
        # softplus and its sigmoid derivative, overflow-safe
        if z > 30:
            sp, sig = z, 1.0
        else:
            sp = np.log1p(np.exp(z))
            sig = 1.0 / (1.0 + np.exp(-z))
        return -sp, g * (sig / self.width), L

    def just_above(self, L):
        """Whether *L* satisfies the exact constraint."""
        return L > self.Lmin


class DynamicHMCSampler:
    """Step sampler: NUTS chains on the flattened surface.

    Parameters
    ----------
    ndim: int
        dimensionality
    nsteps: int
        trajectories per chain until the sample counts as independent
    transform_loglike_gradient: function
        ``u -> (p, logl, grad)``; build one with
        :func:`transform_loglike_gradient_from_torch`
    epsilon: float
        initial leapfrog step size (adapted)
    invmassmatrix: array or float
        inverse mass matrix of the dynamics
    """

    def __init__(self, ndim, nsteps, transform_loglike_gradient,
                 epsilon=0.1, invmassmatrix=1.0, adaptive_nsteps=False,
                 delta=0.9, nudge=1.04):
        """Set up for *ndim* dimensions, *nsteps* trajectories per chain."""
        self.ndim = ndim
        self.nsteps = nsteps
        # every constructor argument is kept under its own name, so that
        # the calibrator's clone equals its prototype
        self.transform_loglike_gradient = transform_loglike_gradient
        self.adaptive_nsteps = adaptive_nsteps
        self.epsilon = float(epsilon)
        self.invmassmatrix = invmassmatrix
        self.delta = delta
        self.nudge = nudge
        self.nrejects = 0
        self.logstat = []
        self.logstat_labels = ['acceptance_rate', 'epsilon']

    def __str__(self):
        """Short description."""
        return 'DynamicHMCSampler(nsteps=%d, epsilon=%g)' % (
            self.nsteps, self.epsilon)

    @property
    def scale(self):
        """Alias for the step size (integrator diagnostics)."""
        return self.epsilon

    def region_changed(self, Ls, region):
        """No-op: dynamics use gradients, not the region."""
        pass

    def plot(self, filename=None):
        """Statistics plotting stub (see ``logstat``)."""
        pass

    def __next__(self, region, Lmin, us, Ls, transform, loglike, ndraw=10,
                 plot=False, tregion=None, log=False):
        """Run one full chain; returns ``(u, p, L, nc)``."""
        problem = FlattenedProblem(Lmin, self.transform_loglike_gradient)
        i = np.random.randint(len(us))
        theta = us[i].copy()
        logp, grad, L = problem(theta)
        nc = 1
        naccepted = 0
        for _ in range(self.nsteps):
            r0 = generate_momentum_flattened(self.ndim, self.invmassmatrix)
            th, L_new, accepted, dnc = tree_sample(
                theta, logp, r0, grad, L, self.epsilon, self.invmassmatrix,
                problem)
            nc += dnc
            if accepted and problem.just_above(L_new):
                theta = th
                logp, grad, L = problem(theta)
                nc += 1
                naccepted += 1
        rate = naccepted / max(self.nsteps, 1)
        self.logstat.append([rate, self.epsilon])
        if rate < self.delta:
            self.epsilon /= self.nudge
        else:
            self.epsilon *= self.nudge ** 0.25
        if not (L > Lmin) or not (np.all(theta > 0) and np.all(theta < 1)):
            self.nrejects += 1
            return None, None, None, nc
        p = transform(theta.reshape((1, -1)))
        return theta, p[0], L, nc
