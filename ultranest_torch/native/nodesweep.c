/* Native run of an improvement pass's counting-only node visits.
 *
 * A pass after the first revisits the whole tree of the earlier passes;
 * at most of its visits the per-node loop of the reactive integrator
 * (ultranest_torch/integrator.py::_explore_pass) only takes the
 * frontier's minimum, decides not to expand it, records it and advances
 * the counters.  This routine consumes a run of such visits in one call,
 * in the exact order and arithmetic of that loop, and stops *before* the
 * first visit at which the loop would do more than count:
 *
 *  - advice is due: not Lmin <= Lhi, or every live value equals Lmin;
 *  - the node would be expanded (_should_node_be_expanded, evaluated
 *    from the state that only an expansion changes);
 *  - a plateau visit while the caller logs (the loop logs each one);
 *  - the iteration count is a multiple of 64 and the frontier holds no
 *    node with children (the loop then asks whether the device segment
 *    path may run);
 *  - the frontier is empty, or the caller's buffers are full.
 *
 * The tree arrives flattened once a pass (netiter.NodeSweep): per point
 * pile id its value, number of children, position of its first child and
 * least number of children wanted; per position the pile id, children of
 * one node contiguous.  A pile id beyond the table is a node made in this
 * pass and not yet visited, so it has no children.
 *
 * The counters advance through ns_counter_step (counters.c), visit by
 * visit, with the live-value tail estimate, which only the state after
 * the run's last visit keeps, computed once at the end.  The frontier
 * follows BreadthFirstIterator: the first index of the minimum value
 * (numpy's argmin rule), one child in place, a leaf removed, two or more
 * children removed and appended.
 */

#include <math.h>
#include <stdint.h>
#include <stdlib.h>
#include <string.h>

int ns_counter_step(
    long nb, double Li, long nchildren,
    const uint8_t *active,
    double *all_logZ, double *all_H, double *all_logVol,
    int64_t *nlive,
    double *logwidth_out,
    const double *values, long nvals,
    double *all_logZremain,
    double *scalars_out);

/* the int64 parameter vector */
enum {
    I_N,           /* in/out: frontier length */
    I_CAP,         /* frontier capacity */
    I_IT,          /* the pass's iteration count at the run's start */
    I_MAX_ITERS,   /* iteration budget, < 0: none */
    I_OVER_CALLS,  /* the call budget is spent */
    I_HEALTHY,     /* live points healthy */
    I_CLUSTER_W,   /* cluster_num_live_points x clusters of > 1 point */
    I_SEQ_K,       /* in/out: first entry of the width schedule in force */
    I_SEQ_LEN,     /* entries of the width schedule */
    I_PLATEAU_STOP,/* stop before a plateau visit */
    I_CHECK_ORDER, /* the counter's insertion-order test is on */
    I_ACC_N,       /* in/out: the test's accumulated count */
    I_MAXV,        /* most visits a call may consume */
    I_TLEN,        /* pile ids covered by the table */
    I_NB,          /* counters */
    I_M,           /* out: visits consumed */
    I_STOP,        /* out: why the run stopped (NS_STOP_*) */
    I_NRUNS,       /* out: insertion-order runs completed */
    I_LEAVES,      /* out: leaves passed */
    I_ZERR_SET,    /* out: the main counter's logZerr was updated */
    I_NPARAMS
};

/* the float64 parameter vector */
enum {
    D_LLO, D_LHI,
    D_THR,         /* insertion-order reset threshold, sigmas */
    D_ACC_SUM,     /* in/out: the test's rank sum */
    D_ZERR,        /* out: the main counter's last logZerr */
    D_NPARAMS
};

/* the pointer vector */
enum {
    P_TVAL, P_TNCH, P_TFIRST, P_TNMIN,   /* by pile id */
    P_PPID,                              /* by position */
    P_SEQL, P_SEQW,                      /* width schedule */
    P_AVAL, P_AROOT, P_APID,             /* frontier, in/out */
    P_PREV, P_SORTED,                    /* scratch, frontier capacity */
    P_ROOTMASK,                          /* (nroots, nb) uint8 */
    P_LOGZ, P_H, P_LOGVOL, P_NLIVE, P_LOGZREMAIN, P_SCALARS,
    P_OUT_PID, P_OUT_VAL,                /* (maxv,) per visit */
    P_OUT_OPS,                           /* (maxv, 3): index, nch, first */
    P_OUT_LOGW,                          /* (maxv, nb) */
    P_OUT_RUNS,                          /* insertion-order run lengths */
    P_NPTRS
};

enum {
    NS_STOP_EMPTY, NS_STOP_ADVICE, NS_STOP_EXPAND, NS_STOP_SEGMENT,
    NS_STOP_PLATEAU, NS_STOP_FULL
};

static int cmp_double(const void *pa, const void *pb)
{
    double a = *(const double *)pa, b = *(const double *)pb;
    return (a > b) - (a < b);
}

/* remove entry i of the frontier */
static void remove_at(double *val, int64_t *root, int64_t *pid,
                      int64_t n, int64_t i)
{
    size_t tail = (size_t)(n - i - 1);
    memmove(val + i, val + i + 1, tail * sizeof(double));
    memmove(root + i, root + i + 1, tail * sizeof(int64_t));
    memmove(pid + i, pid + i + 1, tail * sizeof(int64_t));
}

int64_t ns_node_run(int64_t *iv, double *dv, void **pv)
{
    const double *tval = pv[P_TVAL];
    const int64_t *tnch = pv[P_TNCH];
    const int64_t *tfirst = pv[P_TFIRST];
    const int64_t *tnmin = pv[P_TNMIN];
    const int64_t *ppid = pv[P_PPID];
    const double *seqL = pv[P_SEQL];
    const double *seqW = pv[P_SEQW];
    double *aval = pv[P_AVAL];
    int64_t *aroot = pv[P_AROOT];
    int64_t *apid = pv[P_APID];
    double *prev = pv[P_PREV];
    double *sorted = pv[P_SORTED];
    const uint8_t *rootmask = pv[P_ROOTMASK];
    double *logZ = pv[P_LOGZ];
    double *H = pv[P_H];
    double *logVol = pv[P_LOGVOL];
    int64_t *nlive = pv[P_NLIVE];
    double *logZremain = pv[P_LOGZREMAIN];
    double *scalars = pv[P_SCALARS];
    int64_t *out_pid = pv[P_OUT_PID];
    double *out_val = pv[P_OUT_VAL];
    int64_t *out_ops = pv[P_OUT_OPS];
    double *out_logw = pv[P_OUT_LOGW];
    int64_t *out_runs = pv[P_OUT_RUNS];

    int64_t n = iv[I_N];
    const int64_t cap = iv[I_CAP];
    int64_t it = iv[I_IT];
    const int64_t max_iters = iv[I_MAX_ITERS];
    const int over_calls = iv[I_OVER_CALLS] != 0;
    const int healthy = iv[I_HEALTHY] != 0;
    const double cluster_w = (double)iv[I_CLUSTER_W];
    int64_t k = iv[I_SEQ_K];
    const int64_t seq_len = iv[I_SEQ_LEN];
    const int plateau_stop = iv[I_PLATEAU_STOP] != 0;
    const int check_order = iv[I_CHECK_ORDER] != 0;
    int64_t acc_n = iv[I_ACC_N];
    const int64_t maxv = iv[I_MAXV];
    const int64_t tlen = iv[I_TLEN];
    const long nb = (long)iv[I_NB];
    const double Llo = dv[D_LLO], Lhi = dv[D_LHI], thr = dv[D_THR];
    double acc_sum = dv[D_ACC_SUM];
    double zerr = dv[D_ZERR];
    int zerr_set = 0;

    int64_t m = 0, nruns = 0, leaves = 0, stop;
    int64_t prev_n = 0, prev_nlive0 = 1;

    for (;;) {
        if (n == 0) { stop = NS_STOP_EMPTY; break; }
        if (m >= maxv) { stop = NS_STOP_FULL; break; }
        if (m > 0 && (it & 63) == 0) {
            int childless = 1;
            for (int64_t j = 0; j < n && childless; j++)
                childless = !(apid[j] < tlen && tnch[apid[j]] > 0);
            if (childless) { stop = NS_STOP_SEGMENT; break; }
        }

        /* argmin, first index on ties (a NaN is the minimum), and how
         * many live values equal the minimum */
        int64_t i = 0, neq = 1;
        double Lmin = aval[0];
        if (!isnan(Lmin))
            for (int64_t j = 1; j < n; j++) {
                const double v = aval[j];
                if (isnan(v)) { i = j; Lmin = v; break; }
                if (v < Lmin) { i = j; Lmin = v; neq = 1; }
                else if (v == Lmin) neq++;
            }
        if (!(Lmin <= Lhi) || neq == n) { stop = NS_STOP_ADVICE; break; }

        const int64_t pid = apid[i];
        const int known = pid < tlen;
        const int64_t nc = known ? tnch[pid] : 0;
        const int64_t first = known ? tfirst[pid] : -1;
        if (n - 1 + nc > cap) { stop = NS_STOP_FULL; break; }

        /* _should_node_be_expanded; every branch but the last answers no */
        if (Llo <= Lhi && healthy
                && !(it > 0 && (over_calls
                                || (max_iters >= 0 && it >= max_iters)))) {
            if (neq > 1) {
                if (plateau_stop) { stop = NS_STOP_PLATEAU; break; }
            } else {
                while (k + 1 < seq_len && Lmin > seqL[k])
                    k++;
                double width = seqW[k] >= cluster_w ? seqW[k] : cluster_w;
                const int64_t nmin = known ? tnmin[pid] : 1;
                if (nc < nmin && !((double)n > width && it > 0)) {
                    stop = NS_STOP_EXPAND;
                    break;
                }
            }
        }

        /* the visit: counters (tail deferred), insertion order, frontier */
        const int64_t nlive0 = nlive[0];
        memcpy(prev, aval, (size_t)n * sizeof(double));
        prev_n = n;
        prev_nlive0 = nlive0;
        ns_counter_step(nb, Lmin, (long)nc, rootmask + aroot[i] * nb,
                        logZ, H, logVol, nlive, out_logw + m * nb,
                        aval, 0, logZremain, scalars);
        if (nc >= 1 && !isnan(scalars[1])) {
            zerr = scalars[1];
            zerr_set = 1;
        }
        if (check_order && nc >= 1) {
            memcpy(sorted, aval, (size_t)n * sizeof(double));
            qsort(sorted, (size_t)n, sizeof(double), cmp_double);
            int unique = 1;
            for (int64_t j = 0; j + 1 < n && unique; j++)
                unique = sorted[j] != sorted[j + 1];
            for (int64_t c = 0; unique && c < nc; c++) {
                const double cv = tval[ppid[first + c]];
                int64_t rank = 0;
                for (int64_t j = 0; j < n; j++)
                    rank += aval[j] < cv;
                acc_sum += (rank + 0.5) / (double)nlive0;
                acc_n += 1;
                const double z = (acc_sum - 0.5 * acc_n)
                    / pow(acc_n * (1.0 / 12.0), 0.5);
                if (fabs(z) > thr) {
                    out_runs[nruns++] = acc_n;
                    acc_sum = 0.0;
                    acc_n = 0;
                }
            }
        }

        out_pid[m] = pid;
        out_val[m] = Lmin;
        out_ops[3 * m] = i;
        out_ops[3 * m + 1] = nc;
        out_ops[3 * m + 2] = first;
        if (nc == 1) {
            aval[i] = tval[ppid[first]];
            apid[i] = ppid[first];
        } else {
            const int64_t r = aroot[i];
            remove_at(aval, aroot, apid, n, i);
            n -= 1;
            leaves += nc == 0;
            for (int64_t c = 0; c < nc; c++) {
                aval[n] = tval[ppid[first + c]];
                aroot[n] = r;
                apid[n] = ppid[first + c];
                n += 1;
            }
        }
        m += 1;
        it += 1;
    }

    if (m > 0) {
        /* the tail estimate over the last visit's live values, as
         * ns_counter_step computes it */
        double Lmax = -INFINITY;
        for (int64_t j = 0; j < prev_n; j++)
            if (prev[j] > Lmax) Lmax = prev[j];
        double s = 0.0;
        for (int64_t j = 0; j < prev_n; j++)
            s += exp(prev[j] - Lmax);
        const double tail = log(s) + Lmax
            - log((double)(prev_nlive0 > 0 ? prev_nlive0 : 1));
        double zr_max = -INFINITY;
        for (long j = 0; j < nb; j++) {
            logZremain[j] = logVol[j] + tail;
            if (logZremain[j] > zr_max) zr_max = logZremain[j];
        }
        scalars[0] = logZ[0];
        scalars[2] = logZremain[0];
        scalars[3] = zr_max;
        scalars[4] = exp(logZremain[0] - logZ[0]);
        scalars[5] = 1.0 / (1.0 + exp(logZ[0] - logZremain[0]));
    }

    iv[I_N] = n;
    iv[I_SEQ_K] = k;
    iv[I_ACC_N] = acc_n;
    iv[I_M] = m;
    iv[I_STOP] = stop;
    iv[I_NRUNS] = nruns;
    iv[I_LEAVES] = leaves;
    iv[I_ZERR_SET] = zerr_set;
    dv[D_ACC_SUM] = acc_sum;
    dv[D_ZERR] = zerr;
    return m;
}
