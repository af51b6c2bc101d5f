/* Example C caller of the port's C ABI (the analog of
 * the reference's c/example.c). Build and run:
 *   python -c 'from sassy_tpu_torch import capi; print(capi.build()[1])'
 *   SASSY_DEVICE=cpu PYTHONPATH=<repo> <the printed path>
 * (SASSY_DEVICE unset or "cuda" searches on the GPU.)
 */
#include <math.h>
#include <stdio.h>
#include <string.h>

#include "sassy_tpu.h"

int main(void) {
  sassy_searcher_t *s = sassy_searcher("iupac", 1, NAN);
  if (!s) {
    fprintf(stderr, "failed to create searcher\n");
    return 1;
  }
  const char *pattern = "ATCG";
  const char *text = "AAAATCGGGGATCCGG";
  sassy_match_t *matches = NULL;
  size_t n = sassy_search(s, (const uint8_t *)pattern, strlen(pattern),
                          (const uint8_t *)text, strlen(text), 1, &matches);
  if (n == (size_t)-1) {
    fprintf(stderr, "search failed\n");
    return 1;
  }
  printf("matches: %zu\n", n);
  for (size_t i = 0; i < n; i++) {
    printf("  [%zu, %zu) cost=%d strand=%c\n", matches[i].text_start,
           matches[i].text_end, matches[i].cost,
           matches[i].strand ? '-' : '+');
  }
  sassy_matches_free(matches, n);
  sassy_searcher_free(s);
  return 0;
}
