/* Miniature C header for the TL151 corpus fixture (abi_parity.py).
 *
 * Deliberate skew vs the sibling .py/.cpp:
 *   - LGBM_FixtureCreate takes THREE parameters here; the Python
 *     binding declares two               -> arity finding at the def.
 *   - LGBM_FixtureMissing is declared but has no Python binding
 *                                        -> finding at the directive.
 *   - the cpp defines LGBM_FixtureExtra, absent here
 *                                        -> finding at the impl line.
 */
#ifndef TORCHLINT_CORPUS_ABI_PARITY_H_
#define TORCHLINT_CORPUS_ABI_PARITY_H_

#define FIXTURE_C_EXPORT int

FIXTURE_C_EXPORT LGBM_FixtureCreate(const char* params, int n,
                                    void** out);
FIXTURE_C_EXPORT LGBM_FixtureFree(void* handle);
FIXTURE_C_EXPORT LGBM_FixturePredict(void* handle, const double* data,
                                     int nrow, double* out);
FIXTURE_C_EXPORT LGBM_FixtureMissing(void* handle);

#endif  /* TORCHLINT_CORPUS_ABI_PARITY_H_ */
