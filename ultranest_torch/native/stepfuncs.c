/* Native kernel for the host population slice sampler's shrink/harvest
 * loop (the framework's equivalent of the reference Cython kernel
 * ultranest/stepfuncs.pyx:537-630, update_vectorised_slice_sampler).
 *
 * The per-worker pass is inherently sequential: each worker's proposal
 * must see the interval as shrunk by the workers before it, so numpy
 * cannot vectorize it — exactly why the reference compiled it.  The
 * python/numpy implementation in ultranest_tpu/ops/stepfuncs.py stays
 * as the reference/fallback.
 */

#include <stddef.h>
#include <stdint.h>
#include <string.h>

/* Process one batch of worker proposals.
 *
 * popsize:        number of workers (= rows of the proposal arrays)
 * ndim_u/ndim_p:  columns of u-space / p-space coordinate arrays
 * t:              (popsize,) proposal line coordinates
 * tleft/tright:   (npoints,) slice interval per point, in/out
 * proposed_L:     (popsize,) proposal log-likelihoods
 * proposed_u/p:   (popsize, ndim) proposal coordinates
 * worker_running: (popsize,) int64 point index served by each worker
 * status:         (npoints,) int64, 1 once a point found its successor
 * Lthresh:        likelihood threshold
 * shrink:         shrink factor applied to the accepted interval edge
 * allu/allL/allp: harvest arrays, written at the point's row
 *
 * Returns the number of above-threshold proposals that had to be
 * discarded because their interval had already shrunk past them.
 */
long ns_slice_update(
    long popsize, long ndim_u, long ndim_p,
    const double *t, double *tleft, double *tright,
    const double *proposed_L,
    const double *proposed_u, const double *proposed_p,
    const int64_t *worker_running, int64_t *status,
    double Lthresh, double shrink,
    double *allu, double *allL, double *allp)
{
    long discarded = 0;
    for (long w = 0; w < popsize; w++) {
        const int64_t point = worker_running[w];
        const double tw = t[w];
        if (tw > tright[point] || tw < tleft[point]) {
            if (proposed_L[w] > Lthresh)
                discarded++;
            continue;
        }
        if (tw > 0 && tw < tright[point])
            tright[point] = tw / shrink;
        if (tw < 0 && tw > tleft[point])
            tleft[point] = tw / shrink;
        if (proposed_L[w] > Lthresh && status[point] == 0) {
            status[point] = 1;
            memcpy(allu + point * ndim_u, proposed_u + w * ndim_u,
                   (size_t)ndim_u * sizeof(double));
            allL[point] = proposed_L[w];
            memcpy(allp + point * ndim_p, proposed_p + w * ndim_p,
                   (size_t)ndim_p * sizeof(double));
        }
    }
    return discarded;
}
