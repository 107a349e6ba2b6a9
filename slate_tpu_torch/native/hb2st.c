/* Native CPU bulge-chasing stage 2: Hermitian band -> symmetric
 * tridiagonal (real double).
 *
 * TPU-framework analogue of the reference's CPU-threaded hb2st
 * (reference: src/hb2st.cc:44-187 runs the chase with host threads over
 * a band GATHERED TO ONE NODE — stage 2 is deliberately a single-node
 * CPU stage there too, heev.cc:135).  On this toolchain the on-chip
 * superstep wavefront (ops/bulge.py) is dispatch-latency-bound at
 * ~4 ms x 3n supersteps, while the same arithmetic on the host core is
 * a few seconds: this file is the default stage-2 engine for real f64;
 * ops/bulge.py remains the jittable/portable fallback.
 *
 * Semantics mirror ops/bulge.py's chase_window exactly (same task grid,
 * same larfg, same eliminated-column overwrite), so VS/TAUS feed the
 * SAME on-chip unmtr_hb2st back-transform.
 *
 * Band storage (column-major band, C layout): Wt[c*ldw + d] = A[c+d, c]
 * for d in [0, 2b] (ldw = 2b+1) — the transpose of ops/bulge.py's
 * diagonal-major W, chosen so a column's band entries are contiguous.
 *
 * Task (s, j):  j = 0 head: w0 = s,              r0 = 1
 *               j >= 1:     w0 = s + (j-1)b + 1, r0 = b
 * Reflector rows R = [R0, R0 + b), R0 = w0 + r0 = s + j b + 1; tasks
 * exist while R0 <= n - 2.  The window is cols [w0, w0 + L), L = 3b+1.
 * The two-sided update H A H with H = I - tau v v^T (v on R) touches
 * stored entries only in cols [w0, w0 + 2b) and rows < w0 + L (entries
 * beyond stay zero — same invariant the jax wavefront's truncated
 * write-back relies on).
 *
 * Correct execution order here is the plain sequential one (sweep s
 * fully chased before sweep s+1) — the wavefront in ops/bulge.py is
 * just a parallel-safe reordering of this.
 */

#include <math.h>
#include <stdint.h>
#include <stdlib.h>
#include <string.h>

static void chase_task_d(double *restrict Wt, int64_t ldw, int64_t n_pad,
                         int64_t b, int64_t w0, int64_t r0,
                         double *restrict S, double *restrict v,
                         double *restrict wvec, double *restrict tau_out) {
  const int64_t L = 3 * b + 1;
  const int64_t R0 = w0 + r0;
  const int64_t twob = 2 * b;

  /* -- reflector of column w0, rows [R0, R0+b) (contiguous in Wt) -- */
  const double *colw0 = Wt + w0 * ldw;
  double alpha = colw0[r0];
  double xnorm_sq = 0.0;
  for (int64_t k = 1; k < b; ++k) {
    double xk = colw0[r0 + k];
    xnorm_sq += xk * xk;
  }
  double norm = sqrt(alpha * alpha + xnorm_sq);
  double beta = (alpha == 0.0 ? 1.0 : (alpha > 0.0 ? 1.0 : -1.0)) * -norm;
  int live = norm > 0.0;
  if (!live) beta = alpha;
  double tau = live ? (beta - alpha) / beta : 0.0;
  double scale =
      live ? 1.0 / (alpha == beta ? 1.0 : alpha - beta) : 0.0;
  v[0] = 1.0;
  for (int64_t k = 1; k < b; ++k) v[k] = colw0[r0 + k] * scale;
  *tau_out = tau;

  /* -- S = A[R, w0 : w0+L) from band storage (symmetry for upper).
   * Gathered in two CONTIGUOUS-band passes: the row-major elementwise
   * gather read Wt at stride ldw (a fresh cache line per element) and
   * was the measured runtime of the whole chase (~85% at n=4096).
   * Lower part (r >= cg): each window column holds one contiguous d-run
   * of the rows in R.  Upper part (r < cg): A[r, cg] = A[cg, r], read
   * straight down stored column r.  S writes in the lower pass walk b
   * distinct lines (stride L) that consecutive columns re-hit, so they
   * stay L1-resident. -- */
  for (int64_t c = 0; c < r0 + b; ++c) {
    const int64_t cg = w0 + c;
    const double *col = Wt + cg * ldw;
    const int64_t k_lo = c > r0 ? c - r0 : 0;
    int64_t d = r0 + k_lo - c; /* = max(r0 - c, 0), <= 2b always */
    for (int64_t k = k_lo; k < b; ++k, ++d) S[k * L + c] = col[d];
  }
  for (int64_t k = 0; k < b; ++k) {
    const int64_t r = R0 + k;
    const double *col = Wt + r * ldw;
    double *Sk = S + k * L;
    const int64_t c0 = r0 + k + 1; /* first upper column, < L */
    int64_t cend = c0 + twob - 1;  /* last in-band column */
    if (cend > L - 1) cend = L - 1;
    int64_t dd = 1;
    for (int64_t c = c0; c <= cend; ++c, ++dd) Sk[c] = col[dd];
    for (int64_t c = cend + 1; c < L; ++c) Sk[c] = 0.0;
  }

  /* -- left update S <- (I - tau v v^T) S -- */
  for (int64_t c = 0; c < L; ++c) wvec[c] = 0.0;
  for (int64_t k = 0; k < b; ++k) {
    const double vk = v[k];
    const double *Sk = S + k * L;
    for (int64_t c = 0; c < L; ++c) wvec[c] += vk * Sk[c];
  }
  for (int64_t k = 0; k < b; ++k) {
    const double tvk = tau * v[k];
    double *Sk = S + k * L;
    for (int64_t c = 0; c < L; ++c) Sk[c] -= tvk * wvec[c];
  }

  /* -- right update on the R x R block B = S[:, r0 : r0+b) -- */
  for (int64_t k = 0; k < b; ++k) {
    double *Bk = S + k * L + r0;
    double y = 0.0;
    for (int64_t m = 0; m < b; ++m) y += Bk[m] * v[m];
    const double ty = tau * y;
    for (int64_t m = 0; m < b; ++m) Bk[m] -= ty * v[m];
  }

  /* -- write back modified stored entries (cols [w0, w0+2b)) -- */
  /* cols left of R: rows in R got the left update */
  for (int64_t c = 0; c < r0; ++c) {
    const int64_t cg = w0 + c;
    double *col = Wt + cg * ldw;
    /* stored rows r = cg + d with r in [R0, R0+b): d = R0-cg+k <= 2b */
    const int64_t d0 = R0 - cg;
    const int64_t kmax = (twob - d0 < b - 1) ? twob - d0 : b - 1;
    for (int64_t k = 0; k <= kmax; ++k) col[d0 + k] = S[k * L + c];
  }
  /* cols in R: rows in R from the two-sided block; rows below R_end
   * from the right-update fill via symmetry (S row c-r0, col r-w0) */
  for (int64_t c = r0; c < r0 + b; ++c) {
    const int64_t cg = w0 + c;
    double *col = Wt + cg * ldw;
    const int64_t rend = R0 + b; /* first row past R */
    for (int64_t d = 0; d <= twob; ++d) {
      const int64_t r = cg + d;
      if (r < rend) {
        col[d] = S[(r - R0) * L + c];
      } else if (r - w0 < L) {
        col[d] = S[(c - r0) * L + (r - w0)];
      } else {
        break; /* beyond the window: provably still zero */
      }
    }
  }
  /* exact eliminated-column pattern (numerics hygiene, as in jax) */
  {
    double *col = Wt + w0 * ldw;
    col[r0] = beta;
    for (int64_t k = 1; k < b; ++k) col[r0 + k] = 0.0;
  }
}

/* Chase sweeps [s_begin, s_end) of the band in Wt.  VS: (n_sweeps,
 * jmax1, b), TAUS: (n_sweeps, jmax1), both zero-initialized by the
 * caller.  Sequential ranged calls over a persistent Wt reproduce the
 * full chase exactly (the chase state IS the band; sweeps are chased
 * in order), letting the caller overlap uploads of completed VS/TAUS
 * rows with the next range's compute.  Returns 0 on success. */
int slate_hb2st_range_d(double *restrict Wt, int64_t n, int64_t n_pad,
                        int64_t b, double *restrict VS,
                        double *restrict TAUS, int64_t n_sweeps,
                        int64_t jmax1, int64_t s_begin, int64_t s_end) {
  if (n <= 2 || b <= 1) return 0;
  const int64_t ldw = 2 * b + 1;
  const int64_t L = 3 * b + 1;
  if (n_pad < n + 3 * b) return 1;
  if (s_begin < 0 || s_end > n_sweeps || s_begin > s_end) return 3;
  double *S = (double *)malloc((size_t)(b * L) * sizeof(double));
  double *v = (double *)malloc((size_t)b * sizeof(double));
  double *wvec = (double *)malloc((size_t)L * sizeof(double));
  if (!S || !v || !wvec) {
    free(S); free(v); free(wvec);
    return 2;
  }
  /* Multi-sweep blocking: chase NSW staggered sweeps per block in the
   * proven wavefront order (task (s, j) at t = 3 s + j).  Plain
   * sweep-major order streams the whole O(n b) band once per sweep
   * (~34 GB of strided traffic at n=4096); inside a block the NSW
   * staggered windows overlap (offset b columns), so the band streams
   * roughly once per BLOCK.  Only disjoint-window tasks are reordered
   * relative to sweep-major, so results are bit-identical. */
  const int64_t NSW = 8;
  for (int64_t s0 = s_begin; s0 < s_end; s0 += NSW) {
    const int64_t smax = (s_end - s0 < NSW) ? s_end - s0 : NSW;
    const int64_t tmax = 3 * (smax - 1) + jmax1 - 1;
    for (int64_t t = 0; t <= tmax; ++t) {
      for (int64_t i = (t >= jmax1) ? (t - jmax1) / 3 + 1 : 0;
           i < smax && t - 3 * i >= 0; ++i) {
        const int64_t s = s0 + i;
        const int64_t j = t - 3 * i;
        const int64_t R0 = s + j * b + 1;
        if (R0 > n - 2) continue;
        const int64_t w0 = (j == 0) ? s : s + (j - 1) * b + 1;
        const int64_t r0 = (j == 0) ? 1 : b;
        double tau;
        chase_task_d(Wt, ldw, n_pad, b, w0, r0, S, v, wvec, &tau);
        /* OVERLAP CONTRACT (pairs with the assertion at the async
         * device_put in native/__init__.py): s ranges over
         * [s_begin, s_end) only, so this memcpy writes only VS/TAUS
         * rows of sweeps in [s_begin, s_end) — rows of earlier sweeps
         * are final and may be uploading concurrently. */
        memcpy(VS + (s * jmax1 + j) * b, v, (size_t)b * sizeof(double));
        TAUS[s * jmax1 + j] = tau;
      }
    }
  }
  free(S); free(v); free(wvec);
  return 0;
}

/* Whole-chase convenience wrapper (the original entry point). */
int slate_hb2st_d(double *restrict Wt, int64_t n, int64_t n_pad, int64_t b,
                  double *restrict VS, double *restrict TAUS,
                  int64_t n_sweeps, int64_t jmax1) {
  return slate_hb2st_range_d(Wt, n, n_pad, b, VS, TAUS, n_sweeps, jmax1,
                             0, n_sweeps);
}
