/* C ABI for sassy_tpu_torch: the same surface as the JAX package's
 * c/sassy_tpu.h, which mirrors the reference's C interface
 * (the reference's src/c.rs:16-131, c/sassy.h): create a searcher for an
 * alphabet, search pattern-in-text up to distance k, get a malloc'd array
 * of matches (no CIGAR across the ABI, as in the reference), free both.
 *
 * Implementation: libsassy_tpu_torch_c.so embeds a CPython interpreter and
 * forwards to the sassy_tpu_torch package on the device named by the
 * SASSY_DEVICE environment variable ("cuda" by default, or "cpu"). Build:
 * sassy_tpu_torch.capi.build().
 */
#ifndef SASSY_TPU_H
#define SASSY_TPU_H

#include <stddef.h>
#include <stdint.h>

#ifdef __cplusplus
extern "C" {
#endif

typedef struct sassy_searcher sassy_searcher_t;

/* Strand: 0 = forward, 1 = reverse complement. */
typedef struct {
  size_t text_start;
  size_t text_end;
  size_t pattern_start;
  size_t pattern_end;
  int32_t cost;
  uint8_t strand;
} sassy_match_t;

/* alphabet: "ascii", "dna", or "iupac". rc: also search the reverse
 * complement. alpha: overhang cost per char in [0,1]; pass NAN to disable.
 * Returns NULL on error (the Python error is printed to stderr), also when
 * SASSY_DEVICE is "cuda" (or unset) and there is no CUDA device. */
sassy_searcher_t *sassy_searcher(const char *alphabet, int rc, double alpha);

/* Returns the number of matches and stores a malloc'd array in *out
 * (free with sassy_matches_free). Returns (size_t)-1 on error. */
size_t sassy_search(sassy_searcher_t *searcher, const uint8_t *pattern,
                    size_t pattern_len, const uint8_t *text, size_t text_len,
                    size_t k, sassy_match_t **out);

void sassy_matches_free(sassy_match_t *matches, size_t n);
void sassy_searcher_free(sassy_searcher_t *searcher);

#ifdef __cplusplus
}
#endif

#endif /* SASSY_TPU_H */
