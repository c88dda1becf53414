"""Corpus: TL151 — cross-language C-ABI parity.

Miniature four-surface ABI: the sibling ``abi_parity.h`` declares the
entry points, ``abi_parity.cpp`` defines them and drives the adapter
table below through ``Py_BuildValue``/``call_adapter`` pairs.  Each
planted line carries exactly one deliberate skew; everything else is
in perfect sync and must stay silent.
"""
# torchlint: abi-header=abi_parity.h  # PLANT: TL151
# torchlint: abi-impl=abi_parity.cpp  # PLANT: TL151
#
# The two plants above anchor the surface-level findings: the header
# declares LGBM_FixtureMissing with no binding below (header line),
# and the cpp defines LGBM_FixtureExtra that the header never
# declares (impl line).


def LGBM_FixtureCreate(params, n):  # PLANT: TL151
    # header declares THREE parameters (params, n, out)
    return 0


def LGBM_FixtureFree(handle):
    return 0


def LGBM_FixturePredict(handle, data, nrow, out):
    return 0


# -- adapter table (what the embedded interpreter dispatches into) ------

def _call(fn, *args):
    rc = fn(*args)
    if rc != 0:
        raise RuntimeError(f"fixture ABI call failed: {rc}")


def fixture_create(params, n):
    _call(LGBM_FixtureCreate, n, params, 0)  # PLANT: TL151


def fixture_free(handle):
    _call(LGBM_FixtureFree, handle, 0)  # PLANT: TL151


def fixture_predict(handle, data, nrow, out):  # PLANT: TL151
    # the cpp builds FIVE Py_BuildValue items for this adapter
    _call(LGBM_FixturePredict, handle, data, nrow, out)


def fixture_missing(handle):
    # intact adapter: 1 format value in the cpp, 1 parameter here
    return 0
