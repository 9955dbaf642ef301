"""Property-based fuzz of the compressed coverage upload encoders.

Random int16 buckets (smooth, jumpy, constant, tiny, all-padding) must
satisfy: numpy nibble encoder == C++ nibble encoder byte-for-byte, and
every encoded form decodes back to the exact input. Complements the
deterministic cases in tests/test_encode.py.
"""
import numpy as np
import pytest

from degnorm_jax.data.encode import (OVER_CAP, DeltaEncoded, NibEncoded,
                                     decode_coverage_device, encode_coverage,
                                     nibble_encode, nibble_encode_native)
from degnorm_jax.io.native.build import get_fn

_NATIVE = get_fn("dn_nib_encode") is not None


@pytest.fixture(scope="module", autouse=True)
def _clear_jit_caches_after():
    """Random decode shapes compile many distinct XLA programs; release
    them afterwards (see test_fuzz_engine)."""
    yield
    import jax
    jax.clear_caches()


def random_bucket(rng):
    G = int(rng.integers(1, 12))
    p = int(rng.integers(1, 6))
    W = int(rng.integers(2, 90))
    n_real = int(rng.integers(0, G + 1))
    kind = rng.integers(0, 4)
    F = np.zeros((G, p, W), np.int16)
    for g in range(n_real):
        if kind == 0:          # smooth pileup-like
            base = np.cumsum(rng.integers(-2, 3, size=W))
            F[g] = np.clip(base[None, :] + rng.integers(0, 2, (p, W)),
                           0, 32000)
        elif kind == 1:        # jumpy (drives int8 fallback / exceptions)
            F[g] = rng.integers(0, 32000, (p, W))
        elif kind == 2:        # constant rows
            F[g] = rng.integers(0, 100)
        else:                  # sparse spikes on zeros
            spikes = rng.random((p, W)) < 0.05
            F[g][spikes] = rng.integers(0, 30000, int(spikes.sum()))
    return F, n_real


@pytest.mark.parametrize("seed", range(8))
def test_fuzz_encode_roundtrip_and_native_parity(seed):
    rng = np.random.default_rng(3000 + seed)
    for _ in range(20):
        F, n_real = random_bucket(rng)
        a = nibble_encode(F, n_real=n_real)
        if _NATIVE:
            b = nibble_encode_native(F, n_real=n_real,
                                     threads=int(rng.integers(1, 5)))
            # with the library present, None is impossible for eligible
            # input: the native encoder either produces the byte-identical
            # form or rejects over-cap exactly where the numpy one does
            assert (a is None) == (b is OVER_CAP)
            if a is not None:
                assert isinstance(b, NibEncoded)
                np.testing.assert_array_equal(a.first, b.first)
                np.testing.assert_array_equal(a.nib, b.nib)
                np.testing.assert_array_equal(a.exc_idx, b.exc_idx)
                np.testing.assert_array_equal(a.exc_val, b.exc_val)
                assert a.Wm1 == b.Wm1
        enc = encode_coverage(F, n_real=n_real)
        assert isinstance(enc, (NibEncoded, DeltaEncoded, type(None)))
        if enc is not None:
            dec = np.asarray(decode_coverage_device(enc))
            # padding genes beyond n_real decode to zeros; real genes exact
            expect = F.copy()
            expect[n_real:] = 0
            np.testing.assert_array_equal(dec, expect)
