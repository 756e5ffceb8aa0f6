/* Native consume-min sweep of a finished nested-sampling tree.
 *
 * Replays the breadth-first value-ordered consumption of the whole
 * tree in one call, producing the per-iteration sequence arrays that
 * feed the vectorized integrator replay
 * (ultranest_tpu/netiter.py::_replay_vectorized).  The python
 * equivalent (_sweep_tree_sequence) stays as the reference/fallback;
 * it walks python TreeNode objects and dominated the results-assembly
 * phase (~1 s on a 45k-iteration run).  Here the tree arrives
 * flattened to four arrays (children stored contiguously after their
 * parent's processing order) and the sweep is plain array code.
 *
 * The insertion-rank U-test accumulation (ordertest.py, method of the
 * reference ultranest/ordertest.py) is folded into the same pass:
 * per-child ranks among the sorted active values are only needed for
 * the streaming z-score, so they never leave C.
 *
 * Semantics mirrored exactly from the python sweep:
 *  - next node = first index of the minimum active value
 *    (numpy argmin tie rule);
 *  - expansion replaces the consumed entry in place (1 child),
 *    removes it (leaf), or removes + appends at the end (>=2);
 *  - uniqueness = no two equal values among the actives, tracked as a
 *    count of adjacent equal pairs in the sorted value array;
 *  - child rank = lower-bound position in the sorted actives,
 *    first-child strict-upper count for the insert_order sequence.
 */

#include <math.h>
#include <stdint.h>
#include <stdlib.h>
#include <string.h>

/* first index i in a[0..n) with a[i] >= x */
static int64_t lower_bound(const double *a, int64_t n, double x)
{
    int64_t lo = 0, hi = n;
    while (lo < hi) {
        int64_t mid = (lo + hi) >> 1;
        if (a[mid] < x) lo = mid + 1; else hi = mid;
    }
    return lo;
}

/* first index i in a[0..n) with a[i] > x */
static int64_t upper_bound(const double *a, int64_t n, double x)
{
    int64_t lo = 0, hi = n;
    while (lo < hi) {
        int64_t mid = (lo + hi) >> 1;
        if (a[mid] <= x) lo = mid + 1; else hi = mid;
    }
    return lo;
}

static int cmp_double(const void *pa, const void *pb)
{
    double a = *(const double *)pa, b = *(const double *)pb;
    return (a > b) - (a < b);
}

/* Sweep the flattened tree.
 *
 * nnodes:      total nodes (= iterations produced)
 * nroots:      number of roots (nodes 0..nroots-1)
 * values:      (nnodes,) node ordering values (log-likelihoods)
 * pids:        (nnodes,) point-pile ids
 * nch:         (nnodes,) child counts
 * first_child: (nnodes,) index of the first child; children of a node
 *              occupy first_child[i] .. first_child[i]+nch[i]-1
 * thr:         U-test reset threshold in sigmas (<= 0 disables)
 * Ls/out_ids/out_nch/rtid/nact/cio: (nnodes,) per-iteration outputs
 *              (cio = -1 marks steps without a defined insert rank)
 * runs_out:    (nnodes,) completed U-test run lengths (written count
 *              is packed into acc_state[2])
 * acc_state:   [rank_sum, n, nruns] in/out accumulator state
 * last_value:  [1] out, active value at the final iteration
 *
 * Returns 0 on success, -1 if the sorted-actives invariant breaks
 * (caller falls back to python).
 */
int64_t ns_tree_sweep(
    int64_t nnodes, int64_t nroots,
    const double *values, const int64_t *pids,
    const int64_t *nch, const int64_t *first_child,
    double thr,
    double *Ls, int64_t *out_ids, int64_t *out_nch, int64_t *rtid,
    int64_t *nact, int64_t *cio,
    int64_t *runs_out, double *acc_state, double *last_value)
{
    if (nnodes <= 0 || nroots <= 0)
        return -1;
    double *a_val = malloc(sizeof(double) * nnodes);
    int64_t *a_node = malloc(sizeof(int64_t) * nnodes);
    int64_t *a_root = malloc(sizeof(int64_t) * nnodes);
    double *svals = malloc(sizeof(double) * nnodes);
    if (!a_val || !a_node || !a_root || !svals) {
        free(a_val); free(a_node); free(a_root); free(svals);
        return -1;
    }
    int64_t nactive = nroots;
    for (int64_t i = 0; i < nroots; i++) {
        a_val[i] = values[i];
        a_node[i] = i;
        a_root[i] = i;
        svals[i] = values[i];
    }
    qsort(svals, nroots, sizeof(double), cmp_double);
    int64_t adjdups = 0;
    for (int64_t i = 0; i + 1 < nroots; i++)
        adjdups += svals[i] == svals[i + 1];

    double rank_sum = acc_state[0];
    int64_t acc_n = (int64_t)acc_state[1];
    int64_t nruns = 0;
    int64_t T = 0;
    int64_t status = 0;

    while (nactive > 0) {
        /* argmin, first index on ties */
        int64_t i = 0;
        double v = a_val[0];
        for (int64_t k = 1; k < nactive; k++)
            if (a_val[k] < v) { v = a_val[k]; i = k; }
        if (svals[0] != v) { status = -1; break; }
        int64_t ni = a_node[i];
        int64_t n = nactive;
        int64_t nc = nch[ni];
        int64_t fc = first_child[ni];
        int unique = (n == 1 || adjdups == 0);

        Ls[T] = v;
        out_ids[T] = pids[ni];
        out_nch[T] = nc;
        rtid[T] = a_root[i];
        nact[T] = n;
        if (unique && nc > 0) {
            cio[T] = n - upper_bound(svals, n, values[fc]);
            if (thr > 0) {
                for (int64_t j = 0; j < nc; j++) {
                    int64_t rank = lower_bound(svals, n, values[fc + j]);
                    rank_sum += (rank + 0.5) / (double)n;
                    acc_n += 1;
                    double z = (rank_sum - 0.5 * acc_n)
                        / sqrt(acc_n / 12.0);
                    if (fabs(z) > thr) {
                        runs_out[nruns++] = acc_n;
                        rank_sum = 0.0;
                        acc_n = 0;
                    }
                }
            }
        } else {
            cio[T] = -1;
        }

        /* sorted actives: pop the consumed minimum */
        if (n > 1 && svals[1] == svals[0])
            adjdups -= 1;
        memmove(svals, svals + 1, (size_t)(n - 1) * sizeof(double));
        int64_t nsv = n - 1;
        /* insert the children */
        for (int64_t j = 0; j < nc; j++) {
            double cv = values[fc + j];
            int64_t pos = lower_bound(svals, nsv, cv);
            int left_eq = pos > 0 && svals[pos - 1] == cv;
            int right_eq = pos < nsv && svals[pos] == cv;
            int was_adj = pos > 0 && pos < nsv
                && svals[pos - 1] == svals[pos];
            adjdups += left_eq + right_eq - was_adj;
            memmove(svals + pos + 1, svals + pos,
                    (size_t)(nsv - pos) * sizeof(double));
            svals[pos] = cv;
            nsv += 1;
        }

        /* active set: python-list replacement semantics */
        if (nc == 1) {
            a_node[i] = fc;
            a_val[i] = values[fc];
        } else if (nc == 0) {
            memmove(a_val + i, a_val + i + 1,
                    (size_t)(nactive - i - 1) * sizeof(double));
            memmove(a_node + i, a_node + i + 1,
                    (size_t)(nactive - i - 1) * sizeof(int64_t));
            memmove(a_root + i, a_root + i + 1,
                    (size_t)(nactive - i - 1) * sizeof(int64_t));
            nactive -= 1;
        } else {
            int64_t r = a_root[i];
            memmove(a_val + i, a_val + i + 1,
                    (size_t)(nactive - i - 1) * sizeof(double));
            memmove(a_node + i, a_node + i + 1,
                    (size_t)(nactive - i - 1) * sizeof(int64_t));
            memmove(a_root + i, a_root + i + 1,
                    (size_t)(nactive - i - 1) * sizeof(int64_t));
            nactive -= 1;
            for (int64_t j = 0; j < nc; j++) {
                a_val[nactive] = values[fc + j];
                a_node[nactive] = fc + j;
                a_root[nactive] = r;
                nactive += 1;
            }
        }
        T += 1;
    }

    if (status == 0 && T == nnodes) {
        last_value[0] = Ls[T - 1];
        acc_state[0] = rank_sum;
        acc_state[1] = (double)acc_n;
        acc_state[2] = (double)nruns;
    } else {
        status = -1;
    }
    free(a_val); free(a_node); free(a_root); free(svals);
    return status;
}
