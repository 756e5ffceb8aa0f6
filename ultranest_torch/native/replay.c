/* Native whole-run counter replay.
 *
 * Advances all (1 + nbootstraps) evidence estimators over the full
 * consumed-node sequence of a finished tree in one call — the C
 * equivalent of the numpy matrix math in
 * ultranest_tpu/netiter.py::_replay_vectorized (which remains the
 * reference/fallback).  The numpy version builds ~15 (counters x
 * iterations) temporaries; here each counter runs its recurrence
 * sequentially with O(1) state, writing only the arrays the caller
 * needs (per-step logwidths, pre-step logZ per counter, pre-step
 * main-counter volume, final states).
 *
 * The randomized beta-shrinkage uniforms are drawn by the caller
 * (numpy RNG stream preserved exactly) and passed in as a
 * (n_nonleaf, ncounters) matrix; the main counter's column stays
 * deterministic, matching the python path.
 */

#include <math.h>
#include <stdint.h>

static double logaddexp2_(double a, double b)
{
    if (a == -INFINITY) return b;
    if (b == -INFINITY) return a;
    if (a > b) return a + log1p(exp(b - a));
    return b + log1p(exp(a - b));
}

/* Replay all counters over the consumed-node sequence.
 *
 * T:          iterations (consumed nodes)
 * nb:         counters (1 main + bootstraps)
 * Li:         (T,) node log-likelihoods in consumption order
 * nch:        (T,) child counts
 * rootid:     (T,) root index of each consumed node
 * nact:       (T,) live-arc count at each step (sweep output; used to
 *             cross-check the main counter's bookkeeping)
 * rootmask:   (nb, nroots) uint8 counter membership of each root
 * nroots:     number of roots
 * random_mode: 1 = beta-sampled shrinkage for bootstrap counters
 * u_nl:       (n_nonleaf, nb) uniforms for randomized shrinkage
 *             (unused when random_mode == 0)
 * nl_ord:     (T,) ordinal of each step among non-leaf steps, -1 leaf
 * logw:       (T, nb) out, per-step logwidth rows
 * zprev:      (nb, T) out, pre-step logZ per counter
 * vol0prev:   (T,) out, main-counter pre-step remaining log-volume
 * all_logZ / all_H / all_logVol / nlive_final: (nb,) out finals
 *
 * Returns 0 on success, -1 when the main counter's live-count
 * bookkeeping diverges from the sweep's nact (caller falls back).
 */
int64_t ns_replay_counters(
    int64_t T, int64_t nb, int64_t nroots,
    const double *Li, const int64_t *nch, const int64_t *rootid,
    const int64_t *nact, const uint8_t *rootmask,
    int64_t random_mode, const double *u_nl, const int64_t *nl_ord,
    double *logw, double *zprev, double *vol0prev,
    double *all_logZ, double *all_H, double *all_logVol,
    int64_t *nlive_final)
{
    int64_t status = 0;
    for (int64_t b = 0; b < nb; b++) {
        const uint8_t *mask = rootmask + b * nroots;
        int64_t nlive = 0;
        for (int64_t r = 0; r < nroots; r++)
            nlive += mask[r];
        double logZ = -INFINITY;
        double logVol = 0.0;
        double H = 0.0;
        int started = 0;
        for (int64_t t = 0; t < T; t++) {
            int active = mask[rootid[t]];
            int64_t nc = nch[t];
            int nonleaf = nc >= 1;
            if (b == 0 && nlive != nact[t]) { status = -1; break; }
            double n_safe = nlive >= 1 ? (double)nlive : 1.0;
            double inv_n = 1.0 / n_safe;
            double lw;
            if (nonleaf && active) {
                double logright;
                if (random_mode && b > 0)
                    logright = log(u_nl[nl_ord[t] * nb + b]) / n_safe;
                else
                    logright = -inv_n;
                lw = log1p(-exp(logright)) + logVol;
                double wi = lw + Li[t];
                double logZ_new = logaddexp2_(logZ, wi);
                double expw = exp(wi - logZ_new);
                if (logZ == -INFINITY) {
                    H = expw * Li[t] - logZ_new;
                    started = 1;
                } else if (started) {
                    double a = exp(logZ - logZ_new);
                    H = a * H + expw * Li[t] + a * logZ - logZ_new;
                }
                if (b == 0)
                    vol0prev[t] = logVol;
                logZ = logZ_new;
                logVol += logright;
            } else if (active) {
                /* leaf: tail contribution volume/N */
                lw = logVol - log(n_safe);
                logZ = logaddexp2_(logZ, lw + Li[t]);
                if (b == 0)
                    vol0prev[t] = logVol;
                logVol += log1p(-inv_n);
            } else {
                lw = -INFINITY;
                if (b == 0)
                    vol0prev[t] = logVol;
            }
            logw[t * nb + b] = lw;
            zprev[b * T + t] = logZ;  /* post-step; shifted below */
            nlive += active * (nc - 1);
        }
        if (status != 0)
            break;
        all_logZ[b] = logZ;
        all_H[b] = started ? H : NAN;
        all_logVol[b] = logVol;
        nlive_final[b] = nlive;
        /* convert post-step logZ into pre-step (exclusive shift) */
        double *zrow = zprev + b * T;
        for (int64_t t = T - 1; t >= 1; t--)
            zrow[t] = zrow[t - 1];
        zrow[0] = -INFINITY;
    }
    return status;
}
