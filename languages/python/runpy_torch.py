"""Plain-python (non-vectorized) likelihood example, on the PyTorch port.

Counterpart of ``runpy.py``::

    python runpy_torch.py [--device cpu]
"""
import os
import sys

sys.path.insert(0, os.path.join(
    os.path.dirname(os.path.abspath(__file__)), '..', '..'))

from ultranest_torch import ReactiveNestedSampler  # noqa: E402


def my_likelihood(params):
    """Single-point likelihood (automatically vectorized by the sampler)."""
    return -0.5 * (((params - 0.5) / 0.1) ** 2).sum()


def my_prior_transform(cube):
    """Single-point prior transform."""
    return cube


def main(device='cuda', **run_kwargs):
    """Run the original's sampler; returns the results dict. *run_kwargs*
    override the ``run()`` options."""
    paramnames = ["a", "b", "c"]
    sampler = ReactiveNestedSampler(paramnames, my_likelihood,
                                    transform=my_prior_transform,
                                    device=device)
    results = sampler.run(**dict(dict(min_num_live_points=200,
                                      viz_callback=False), **run_kwargs))
    sampler.print_results()
    return results


if __name__ == '__main__':
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument('--device', default='cuda')
    main(device=ap.parse_args().device)
