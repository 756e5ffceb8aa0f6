/* Native kernel for the per-iteration nested-sampling integrator update.
 *
 * Advances all (1 + nbootstraps) evidence estimators of a MultiCounter
 * by one consumed node: volume shrinkage, logZ logaddexp accumulation,
 * information H recurrence, and the live-value tail estimate.  This is
 * the host hot loop of the framework (called once per NS iteration);
 * the python/numpy equivalent lives in
 * ultranest_tpu/netiter.py::MultiCounter.passing_node and stays as the
 * reference/fallback implementation.
 *
 * Deterministic (random=False) volume shrinkage only; the randomized
 * mode is used by the offline replay, which is vectorized in python.
 */

#include <math.h>
#include <stddef.h>
#include <stdint.h>

static double logaddexp(double a, double b)
{
    if (a == -INFINITY) return b;
    if (b == -INFINITY) return a;
    if (a > b) return a + log1p(exp(b - a));
    return b + log1p(exp(a - b));
}

/* Advance the counters by one consumed node.
 *
 * nb:            number of counters
 * Li:            node log-likelihood
 * nchildren:     number of children of the consumed node
 * active:        (nb,) uint8, whether the node's root is in each counter
 * all_logZ:      (nb,) in/out
 * all_H:         (nb,) in/out (NaN = unset)
 * all_logVol:    (nb,) in/out remaining log-volume
 * nlive:         (nb,) int64 in/out live-arc counts
 * logwidth_out:  (nb,) out, the logweights row for this iteration
 * values:        (nvals,) current live log-likelihoods (incl. this node)
 * all_logZremain:(nb,) out tail estimates
 * scalars_out:   [logZ0, logZerr0, logZremain0, logZremainMax,
 *                 remainder_ratio, remainder_fraction]
 */
int ns_counter_step(
    long nb, double Li, long nchildren,
    const uint8_t *active,
    double *all_logZ, double *all_H, double *all_logVol,
    int64_t *nlive,
    double *logwidth_out,
    const double *values, long nvals,
    double *all_logZremain,
    double *scalars_out)
{
    long j;
    const int64_t nlive0 = nlive[0];

    if (nchildren >= 1) {
        for (j = 0; j < nb; j++) {
            const int64_t n = nlive[j] > 0 ? nlive[j] : 1;
            const double logright = -1.0 / (double)n;
            if (!active[j]) {
                logwidth_out[j] = -INFINITY;
                continue;
            }
            const double logleft = log1p(-exp(logright));
            const double lw = logleft + all_logVol[j];
            const double wi = lw + Li;
            const double z = all_logZ[j];
            const double znew = logaddexp(z, wi);
            double H = exp(wi - znew) * Li
                + exp(z - znew) * (all_H[j] + z) - znew;
            if (isnan(H))
                H = -lw;
            all_H[j] = H;
            all_logZ[j] = znew;
            all_logVol[j] += logright;
            logwidth_out[j] = lw;
        }
    } else {
        for (j = 0; j < nb; j++) {
            const int64_t n = nlive[j] > 0 ? nlive[j] : 1;
            if (!active[j]) {
                logwidth_out[j] = -INFINITY;
                continue;
            }
            const double lw = all_logVol[j] - log((double)n);
            const double wi = lw + Li;
            all_logZ[j] = logaddexp(all_logZ[j], wi);
            /* n == 1: the counter's last arc dies, volume -> -inf */
            all_logVol[j] += (n == 1) ? -INFINITY : log1p(-1.0 / (double)n);
            logwidth_out[j] = lw;
        }
    }

    /* tail estimate over current live values */
    double Lmax = -INFINITY;
    for (j = 0; j < nvals; j++)
        if (values[j] > Lmax) Lmax = values[j];
    double s = 0.0;
    for (j = 0; j < nvals; j++)
        s += exp(values[j] - Lmax);
    const double tail = log(s) + Lmax - log((double)(nlive0 > 0 ? nlive0 : 1));
    double zr_max = -INFINITY;
    for (j = 0; j < nb; j++) {
        all_logZremain[j] = all_logVol[j] + tail;
        if (all_logZremain[j] > zr_max) zr_max = all_logZremain[j];
    }

    /* replace node by its children in the live counts */
    for (j = 0; j < nb; j++)
        if (active[j]) nlive[j] += nchildren - 1;

    scalars_out[0] = all_logZ[0];
    scalars_out[1] = (all_H[0] > 0 && nlive0 > 0)
        ? sqrt(all_H[0] / (double)nlive0) : NAN;
    scalars_out[2] = all_logZremain[0];
    scalars_out[3] = zr_max;
    scalars_out[4] = exp(all_logZremain[0] - all_logZ[0]);
    scalars_out[5] = 1.0 / (1.0 + exp(all_logZ[0] - all_logZremain[0]));
    return 0;
}
