"""Run nested sampling on the PyTorch port with a scalar (one point per
call) C likelihood.

Counterpart of ``runcsimple.py``. This variant passes one parameter
vector per function call. Function calls are expensive; the vectorized
``runc_torch.py`` way is recommended. Build the library first::

    make
    python runcsimple_torch.py [--device cpu]
"""
import ctypes
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(
    os.path.dirname(os.path.abspath(__file__)), '..', '..'))

from ultranest_torch import ReactiveNestedSampler  # noqa: E402


def load(path=os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "mylib.so")):
    """Load the library at *path* (default: the ``mylib.so`` beside this
    file) and return (transform, loglike) wrappers around its scalar
    entry points."""
    myclib = ctypes.CDLL(path)
    myclib.my_c_transform.argtypes = [
        np.ctypeslib.ndpointer(dtype=np.float64, ndim=1,
                               flags='C_CONTIGUOUS'),
        ctypes.c_size_t]
    myclib.my_c_transform.restype = None
    myclib.my_c_likelihood.argtypes = [
        np.ctypeslib.ndpointer(dtype=np.float64, ndim=1,
                               flags='C_CONTIGUOUS'),
        ctypes.c_size_t]
    myclib.my_c_likelihood.restype = ctypes.c_double

    def mytransformwrapper(cube):
        """Call the C transform on one unit-cube point."""
        params = cube.copy()
        myclib.my_c_transform(params, params.size)
        return params

    def mylikelihoodwrapper(params):
        """Call the C likelihood on one parameter point."""
        return myclib.my_c_likelihood(
            np.ascontiguousarray(params, dtype=np.float64), params.size)

    return mytransformwrapper, mylikelihoodwrapper


def main(path=None, device='cuda', plot=True, **run_kwargs):
    """Run the original's sampler on the library at *path*; returns the
    results dict. *run_kwargs* override the ``run()`` options."""
    mytransformwrapper, mylikelihoodwrapper = \
        load(path) if path else load()
    paramnames = ["a", "b", "c"]
    sampler = ReactiveNestedSampler(paramnames, mylikelihoodwrapper,
                                    transform=mytransformwrapper,
                                    device=device)
    results = sampler.run(**dict(dict(min_num_live_points=100,
                                      viz_callback=False), **run_kwargs))
    sampler.print_results()
    if plot:
        sampler.plot()
    return results


if __name__ == '__main__':
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument('--device', default='cuda')
    main(device=ap.parse_args().device)
