"""Run nested sampling on the PyTorch port with a vectorized Fortran
likelihood (via ctypes).

Counterpart of ``runfort.py``. Build the library first::

    make
    python runfort_torch.py [--device cpu]
"""
import ctypes
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(
    os.path.dirname(os.path.abspath(__file__)), '..', '..'))

from ultranest_torch import ReactiveNestedSampler  # noqa: E402


def load(path=os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "myfortlib.so")):
    """Load the library at *path* (default: the ``myfortlib.so`` beside this
    file) and return the loglike wrapper around its vectorized entry
    point."""
    mylib = ctypes.CDLL(path)
    mylib.my_f_likelihood_vectorized.argtypes = [
        np.ctypeslib.ndpointer(dtype=np.float64, ndim=2,
                               flags='C_CONTIGUOUS'),
        ctypes.c_size_t,
        ctypes.c_size_t,
        np.ctypeslib.ndpointer(dtype=np.float64, ndim=1,
                               flags='C_CONTIGUOUS')]
    mylib.my_f_likelihood_vectorized.restype = None

    def mylikelihoodwrapper(params):
        """Call the Fortran likelihood on a batch of parameter points."""
        params = np.ascontiguousarray(params)
        like = np.zeros(len(params))
        mylib.my_f_likelihood_vectorized(params, params.shape[1], params.shape[0], like)
        return like

    return mylikelihoodwrapper


def main(path=None, device='cuda', **run_kwargs):
    """Run the original's sampler on the library at *path*; returns the
    results dict. *run_kwargs* override the ``run()`` options."""
    mylikelihoodwrapper = load(path) if path else load()
    paramnames = ["a", "b", "c"]
    sampler = ReactiveNestedSampler(paramnames, mylikelihoodwrapper,
                                    vectorized=True, device=device)
    results = sampler.run(**dict(dict(min_num_live_points=400,
                                      viz_callback=False), **run_kwargs))
    sampler.print_results()
    return results


if __name__ == '__main__':
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument('--device', default='cuda')
    main(device=ap.parse_args().device)
