/* Minimal host driver for the UNMODIFIED reference SA kernel, used as a
 * parity oracle for this JAX implementation.
 *
 * The reference's own CPU path (`cudaSaTabsearch -c`) lives inside a CUDA
 * host program we cannot build without the CUDA toolkit; but its kernel
 * source compiles to a plain single-threaded C++ function when CUDA is not
 * defined (reference cudaSaTabsearch_kernel.cu:53-65), and its parser and
 * statistics modules are plain C.  This driver links those three unmodified
 * reference translation units and reproduces the reference CLI contract:
 *
 *   refhost [-r restarts] < input
 *
 * where `input` is the reference stdin protocol (dbfile line, "T T F"
 * options line, query tableaux+distmatrices), and stdout carries the exact
 *   # header lines + "%-8s %d %g %g %g" result lines
 * of cudaSaTabsearch (reference cudaSaTabsearch.cu:416-459).  Query loop,
 * global-variable query staging, small/large two-pass split, and the
 * srand48(1234) seeding (cudaSaTabsearch.cu:871, :1272-1310) all follow the
 * reference driver's semantics.
 *
 * Built by tools/refgolden/build.sh into /tmp (out-of-tree; the reference
 * checkout is read-only).  This file is new code, not copied from the
 * reference driver; it reimplements only as much of main() as the oracle
 * needs (no GPU paths, no query-list mode, no timers).
 */

#include <stdio.h>
#include <stdlib.h>
#include <string.h>
#include <ctype.h>

#include "driver_types.h"
#define __global__ /* host build: strip CUDA qualifiers, kernel.cu:58-63 */
#define curandState int
#include "saparams.h"
#include "parsetableaux.h"
#include "gumbelstats.h"
#include "cudaSaTabsearch_kernel.h"

/* host-compiled kernel's query staging globals (defined in the reference
 * kernel translation unit when CUDA is not defined, kernel.cu:102-106) */
extern int c_qn_host;
extern char c_qtab_host[MAXDIM * MAXDIM];
extern float c_qdmat_host[MAXDIM * MAXDIM];
extern char c_qssetypes_host[MAXDIM];

/* declared extern in cudaSaTabsearch_kernel.h; defined by the driver */
int MAXSTART = DEFAULT_MAXSTART;

static void run_pass(const char *dbfile, int lorder, int lsoln, int maxstart,
                     int maxdim, int dbsize, char *tableaux,
                     float *distmatrices, int *orders, char *names,
                     int num_queries, char *q_tableaux, float *q_distmatrices,
                     int *q_orders, char *q_names) {
  if (dbsize <= 0)
    return;

  cudaExtent tab_extent = {(size_t)maxdim, (size_t)maxdim, (size_t)dbsize};
  cudaPitchedPtr tab_pp = {tableaux, (size_t)maxdim, (size_t)maxdim,
                           (size_t)dbsize};
  cudaExtent dmat_extent = {maxdim * sizeof(float), (size_t)maxdim,
                            (size_t)maxdim};
  cudaPitchedPtr dmat_pp = {distmatrices, maxdim * sizeof(float),
                            (size_t)maxdim, (size_t)maxdim};

  int *scores = (int *)malloc((size_t)dbsize * sizeof(int));
  int *ssemaps = (int *)malloc((size_t)dbsize * MAXDIM * sizeof(int));
  if (!scores || !ssemaps) {
    fprintf(stderr, "out of memory\n");
    exit(1);
  }

  for (int qi = 0; qi < num_queries; qi++) {
    char qid[LABELSIZE + 1];
    memset(qid, 0, sizeof(qid));
    strncpy(qid, q_names + qi * (LABELSIZE + 1), LABELSIZE);
    c_qn_host = q_orders[qi];
    memcpy(c_qtab_host, q_tableaux + (size_t)qi * MAXDIM * MAXDIM,
           sizeof(c_qtab_host));
    memcpy(c_qdmat_host, q_distmatrices + (size_t)qi * MAXDIM * MAXDIM,
           sizeof(c_qdmat_host));
    for (int i = 0; i < c_qn_host; i++)
      c_qssetypes_host[i] =
          c_qtab_host[INDEX2D(i, i, MAXDIM, MAXDIM)];

    printf("# cudaSaTabsearch LTYPE = T LORDER = %c LSOLN = %c\n",
           lorder ? 'T' : 'F', lsoln ? 'T' : 'F');
    printf("# QUERY ID = %-8s\n", qid);
    printf("# DBFILE = %-80s\n", dbfile);

    int state = 0;
    sa_tabsearch_host(dbsize, lorder, lsoln, maxstart, tab_pp, tab_extent,
                      orders, dmat_pp, dmat_extent, scores, ssemaps, &state);

    for (int i = 0; i < dbsize; i++) {
      double norm2score = norm2(scores[i], c_qn_host, orders[i]);
      double zscore = z_gumbel(norm2score, gumbel_a, gumbel_b);
      double pvalue = pv_gumbel(zscore);
      printf("%-8s %d %g %g %g\n", names + i * (LABELSIZE + 1), scores[i],
             norm2score, zscore, pvalue);
      if (lsoln)
        for (int k = 0; k < c_qn_host; k++)
          if (ssemaps[i * MAXDIM + k] >= 0)
            printf("%3d %3d\n", k + 1, ssemaps[i * MAXDIM + k] + 1);
    }
  }
  free(scores);
  free(ssemaps);
}

int main(int argc, char **argv) {
  int maxstart = DEFAULT_MAXSTART;
  for (int a = 1; a < argc; a++) {
    if (!strcmp(argv[a], "-r") && a + 1 < argc)
      maxstart = atoi(argv[++a]);
    else {
      fprintf(stderr, "usage: %s [-r restarts] < input\n", argv[0]);
      return 1;
    }
  }
  MAXSTART = maxstart;

  char dbfile[MAX_LINE_LEN];
  char options[MAX_LINE_LEN];
  if (!fgets(dbfile, sizeof(dbfile), stdin) ||
      !fgets(options, sizeof(options), stdin)) {
    fprintf(stderr, "bad input header\n");
    return 1;
  }
  dbfile[strcspn(dbfile, " \t\r\n")] = '\0';
  char cltype = 0, clorder = 0, clsoln = 0;
  if (sscanf(options, " %c %c %c", &cltype, &clorder, &clsoln) != 3) {
    fprintf(stderr, "bad options line\n");
    return 1;
  }
  int lorder = (toupper(clorder) == 'T');
  int lsoln = (toupper(clsoln) == 'T');
  /* reference forces LTYPE=T (cudaSaTabsearch.cu:696-700) */

  char *q_tableaux;
  float *q_distmatrices;
  int *q_orders;
  char *q_names;
#ifdef REFGOLDEN_CUDA5
  /* cuda5-era parser has no read_queries(); single query parsed inline as
   * in old/nvcc_src_cuda5/cudaSaTabsearch.cu:633-647 */
  int num_queries = 1;
  static char qtab[MAXDIM * MAXDIM];
  static float qdmat[MAXDIM * MAXDIM];
  static int qorder;
  static char qname[LABELSIZE + 1];
  if (fscanf(stdin, "%8s %d\n", qname, &qorder) != 2 ||
      parse_tableau(stdin, MAXDIM, qorder, qtab) < 0 ||
      parse_distmatrix(stdin, MAXDIM, qorder, qdmat, 0) < 0) {
    fprintf(stderr, "bad query\n");
    return 1;
  }
  q_tableaux = qtab;
  q_distmatrices = qdmat;
  q_orders = &qorder;
  q_names = qname;
#else
  int num_queries =
      read_queries(stdin, &q_tableaux, &q_distmatrices, &q_orders, &q_names);
  if (num_queries < 1) {
    fprintf(stderr, "no queries read\n");
    return 1;
  }
#endif

  FILE *dbfp = fopen(dbfile, "r");
  if (!dbfp) {
    fprintf(stderr, "cannot open db file %s\n", dbfile);
    return 1;
  }
  char *tableaux, *large_tableaux;
  float *distmatrices, *large_distmatrices;
  int *orders, *large_orders;
  char *names, *large_names;
  int large_dbsize = 0;
  int dbsize = read_database(dbfp, &tableaux, &distmatrices, &large_tableaux,
                             &large_distmatrices, &orders, &names,
                             &large_orders, &large_names, &large_dbsize);
  fclose(dbfp);
  if (dbsize < 0) {
    fprintf(stderr, "error reading db\n");
    return 1;
  }
  dbsize -= large_dbsize; /* read_database returns the TOTAL entry count;
                             small pass covers only order<=MAXDIM_GPU
                             (reference cudaSaTabsearch.cu:676) */
  fprintf(stderr, "read %d small + %d large db entries\n", dbsize,
          large_dbsize);

  srand48(1234);

  run_pass(dbfile, lorder, lsoln, maxstart, MAXDIM_GPU, dbsize, tableaux,
           distmatrices, orders, names, num_queries, q_tableaux,
           q_distmatrices, q_orders, q_names);
  run_pass(dbfile, lorder, lsoln, maxstart, MAXDIM, large_dbsize,
           large_tableaux, large_distmatrices, large_orders, large_names,
           num_queries, q_tableaux, q_distmatrices, q_orders, q_names);
  return 0;
}
