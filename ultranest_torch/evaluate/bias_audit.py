"""Bias audit of the speculative-shrink population slice engine, on the
PyTorch port.

Counterpart of ``evaluate/bias_audit.py`` (same problems, settings,
verdict and exit code): repeats a problem with known analytic logZ over
many seeds through ``FusedPopulationSliceSampler(engine='spec')`` and
tests whether the per-seed z-scores z_i = (logZ_i - truth) / logzerr_i
are centered on zero: the engine is unbiased iff mean(z) is compatible
with 0 at ~1/sqrt(N) resolution. The port's walks draw from torch's
Philox streams, never the JAX package's threefry, so no single seed can
be compared with the JAX package's: only seed-pooled statistics can.

Usage::

    python -m ultranest_torch.evaluate.bias_audit [--seeds 10] \
        [--problem asymgauss50] [--device cpu] [--out FILE] \
        [--jax-record evaluate/records/bias_audit_anchors_r5_2026-08-20.json]

Prints one JSON line per problem with the per-seed results and the
verdict (``--out`` appends each line to FILE too), and exits nonzero
when |mean z| > 2.5/sqrt(N). Besides the JAX tool's problems
(:data:`PROBLEMS`, its copy) the port has its own (:data:`PORT_PROBLEMS`:
gauss100 at a fixed nsteps of 800, no governor). With ``--jax-record``
each line also holds a Welch two-sample comparison of the mean logZ
with the JAX package's rows of the same problem in that record
(:func:`welch`; a port entry names the JAX problem it is held to as its
``anchor``): per-seed logZ is the one statistic both packages share,
their random streams never matching seed by seed.
"""

import argparse
import json
import sys
import time

import numpy as np

PROBLEMS = {
    # name -> (problem factory kwargs, sampler settings; skw = extra
    # FusedPopulationSliceSampler kwargs)
    'asymgauss50': dict(factory='asymgauss', fkw=dict(ndim=50, sigma_min=0.01),
                        popsize=4096, nsteps=100),
    'asymgauss15': dict(factory='asymgauss', fkw=dict(ndim=15, sigma_min=0.05),
                        popsize=512, nsteps=30),
    'shell8': dict(factory='shell', fkw=dict(ndim=8, r=0.2, w=0.004),
                   popsize=512, nsteps=40),
    # the two 100-d bench anchors at the bench's configuration (popsize
    # 2048, nsteps 100 under the jump-distance governor, spec_depth
    # class default)
    'gauss100': dict(factory='gauss', fkw=dict(ndim=100, sigma=0.1),
                     popsize=2048, nsteps=100,
                     skw=dict(adaptive_nsteps=True)),
    'gauss100_hard': dict(factory='gauss', fkw=dict(ndim=100, sigma=0.01),
                          popsize=2048, nsteps=100,
                          skw=dict(adaptive_nsteps=True)),
}


# the port's own entries, beyond the JAX tool's; 'anchor' names the JAX
# record's problem the seed-pooled logZ is compared with
PORT_PROBLEMS = {
    # gauss100 with the chain length fixed at the governor's highest
    # (800 steps, no adaptive_nsteps): whether the +0.5-nat offset of the
    # 100-d anchors is the governor's
    'gauss100_fixed800': dict(factory='gauss', fkw=dict(ndim=100, sigma=0.1),
                              popsize=2048, nsteps=800, anchor='gauss100'),
}


def welch(rows, ref_rows):
    """Welch's two-sample t test of the mean logZ of *rows* against
    *ref_rows* (each a list of dicts with ``logz``): the two means and
    their standard errors, t, the Welch-Satterthwaite degrees of freedom
    and the two-sided p-value."""
    from scipy import stats
    a = np.array([r['logz'] for r in rows], float)
    b = np.array([r['logz'] for r in ref_rows], float)
    va, vb = a.var(ddof=1) / len(a), b.var(ddof=1) / len(b)
    t = (a.mean() - b.mean()) / np.sqrt(va + vb)
    df = (va + vb) ** 2 / (va ** 2 / (len(a) - 1) + vb ** 2 / (len(b) - 1))
    return dict(mean=round(float(a.mean()), 4),
                se=round(float(np.sqrt(va)), 4), n=len(a),
                ref_mean=round(float(b.mean()), 4),
                ref_se=round(float(np.sqrt(vb)), 4), ref_n=len(b),
                t=round(float(t), 3), df=round(float(df), 2),
                p=round(float(2 * stats.t.sf(abs(t), df)), 4))


def record_rows(path, name):
    """The rows of problem *name* in the audit record at *path*: a JSON
    object with a ``problems`` map (the JAX package's records) or one
    audit line."""
    with open(path) as f:
        rec = json.load(f)
    line = rec['problems'][name] if 'problems' in rec else rec
    if line.get('problem', name) != name:
        raise KeyError('%s holds %s, not %s' % (path, line['problem'], name))
    return line['rows']


def run_one(spec, seed, dlogz=2.0, engine='spec', device='cuda'):
    """One seeded run of *spec* (an entry of :data:`PROBLEMS`); returns
    its row (seed, wall_s, logz, logzerr, ncall, truth and, where the
    governor moved it, nsteps_final)."""
    from ultranest_torch import ReactiveNestedSampler
    from ultranest_torch.mlfriends import ScalingLayer, SimpleRegion
    from ultranest_torch.models import problems as models
    from ultranest_torch.popfused import FusedPopulationSliceSampler

    prob = getattr(models, spec['factory'])(**spec['fkw'])
    sampler = ReactiveNestedSampler(seed=seed, device=device,
                                    **prob.sampler_kwargs(use_torch=False))
    sampler.transform_layer_class = ScalingLayer
    # spec_depth left at the class default so the audit covers the
    # shipped configuration
    sampler.stepsampler = FusedPopulationSliceSampler(
        popsize=spec['popsize'], nsteps=spec['nsteps'],
        torch_loglike=prob.torch_loglike,
        torch_transform=getattr(prob, 'torch_transform', None),
        seed=seed, engine=engine, device=device, **spec.get('skw', {}))
    t0 = time.time()
    results = sampler.run(
        min_num_live_points=400, viz_callback=False, show_status=False,
        max_num_improvement_loops=0, min_ess=0, dlogz=dlogz,
        frac_remain=0.1, region_class=SimpleRegion,
        cluster_num_live_points=0)
    row = dict(seed=seed, wall_s=round(time.time() - t0, 2),
               logz=float(results['logz']),
               logzerr=float(results['logzerr']),
               ncall=int(results['ncall']), truth=float(prob.logz))
    nsteps_final = getattr(sampler.stepsampler, 'nsteps', None)
    if nsteps_final is not None and nsteps_final != spec['nsteps']:
        row['nsteps_final'] = int(nsteps_final)
    return row


def verdict(name, rows, engine='spec'):
    """The audit line of *rows*: per-seed z, their mean, the bound
    2.5/sqrt(N) and whether |mean z| is inside it."""
    z = np.array([(r['logz'] - r['truth']) / r['logzerr'] for r in rows])
    mean_z = float(z.mean())
    bound = 2.5 / np.sqrt(len(z))
    return dict(problem=name, seeds=len(rows), engine=engine,
                z=[round(v, 3) for v in z],
                mean_z=round(mean_z, 3), bound=round(bound, 3),
                unbiased=bool(abs(mean_z) < bound),
                rows=rows)


def audit(name, seeds, engine='spec', device='cuda', out=None, meta=None,
          jax_record=None):
    """Run seeds 1..*seeds* of *name*, print the audit line (with *meta*
    merged in, and with *jax_record* the :func:`welch` comparison with
    that record's rows of the problem's anchor) and append it to the
    file *out*, if given."""
    spec = PORT_PROBLEMS[name] if name in PORT_PROBLEMS else PROBLEMS[name]
    rows = []
    for seed in range(1, seeds + 1):
        rows.append(run_one(spec, seed, engine=engine, device=device))
        print('ROW %s %s' % (name, json.dumps(rows[-1])), flush=True)
    line = verdict(name, rows, engine=engine)
    if jax_record:
        anchor = spec.get('anchor', name)
        line['welch'] = dict(welch(rows, record_rows(jax_record, anchor)),
                             record=jax_record, anchor=anchor)
    line.update(meta or {})
    print(json.dumps(line), flush=True)
    if out:
        with open(out, 'a') as f:
            f.write(json.dumps(line) + '\n')
    return line


def device_meta(device):
    """The card's name and power limit (``nvidia-smi``), the torch
    version and the device, for the record."""
    import subprocess

    import torch
    meta = dict(device=str(device), torch=torch.__version__)
    if str(device).startswith('cuda'):
        smi = subprocess.run(
            ['nvidia-smi', '--query-gpu=name,power.limit',
             '--format=csv,noheader'],
            capture_output=True, text=True, timeout=60, check=True)
        meta['card'] = smi.stdout.strip().splitlines()[0]
    return meta


def main(argv=None, device='cuda'):
    """Parse *argv* (default ``sys.argv[1:]``) and run the audits;
    returns the exit code. ``--device`` overrides *device*."""
    ap = argparse.ArgumentParser()
    ap.add_argument('--seeds', type=int, default=10)
    ap.add_argument('--problem', action='append', default=None,
                    choices=sorted(PROBLEMS) + sorted(PORT_PROBLEMS),
                    dest='problems')
    ap.add_argument('--engine', default='spec',
                    choices=['spec', 'async', 'sync'],
                    help='population engine to audit')
    ap.add_argument('--device', default=device)
    ap.add_argument('--out', default=None,
                    help='also append each JSON line to this file')
    ap.add_argument('--commit', default=None,
                    help='commit of the code audited, for the record')
    ap.add_argument('--jax-record', default=None,
                    help='a JAX audit record to compare the mean logZ with')
    args = ap.parse_args(argv)
    problems = args.problems or ['asymgauss50', 'shell8']
    meta = device_meta(args.device)
    if args.commit:
        meta['commit'] = args.commit
    ok = all([audit(p, args.seeds, engine=args.engine, device=args.device,
                    out=args.out, meta=meta,
                    jax_record=args.jax_record)['unbiased']
              for p in problems])
    return 0 if ok else 1


if __name__ == '__main__':
    sys.exit(main())
