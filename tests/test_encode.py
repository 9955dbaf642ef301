"""int8-delta coverage upload encoding: losslessness and engine parity."""
import numpy as np

from degnorm_jax.data.encode import delta_decode_device, delta_encode
from tests.conftest import random_coverage


def test_roundtrip_lossless():
    rng = np.random.default_rng(1)
    mats = [random_coverage(rng, 4, 300) for _ in range(5)]
    G = len(mats)
    W = max(m.shape[1] for m in mats)
    F = np.zeros((G, 4, W), np.float32)
    for i, m in enumerate(mats):
        F[i, :, :m.shape[1]] = np.round(m)
    F[1, 2, 7] = 12000.0                      # delta exception
    enc = delta_encode(F)
    assert enc is not None
    dec = np.asarray(delta_decode_device(*map(np.asarray, enc)))
    np.testing.assert_array_equal(dec.astype(np.float32), F)
    nbytes = sum(np.asarray(a).nbytes for a in enc)
    assert nbytes < 0.55 * F.size * 2         # ~half of the int16 form


def test_int16_input_and_pad_skip_roundtrip():
    """int16-packed buckets (data/buckets.py integral_int16able path) must
    encode identically to the float32 form, and trailing padding genes
    (n_real) must decode to zeros."""
    rng = np.random.default_rng(2)
    G, p, W = 6, 4, 256
    F = np.zeros((G, p, W), np.float32)
    for i in range(4):                         # genes 4,5 are padding
        m = np.round(random_coverage(rng, p, W - 16 * i))
        F[i, :, :m.shape[1]] = m
    F[0, 1, 5] = 9000.0                        # delta exception
    enc_f = delta_encode(F, n_real=4)
    enc_i = delta_encode(F.astype(np.int16), n_real=4)
    assert enc_f is not None and enc_i is not None
    for a, b in zip(enc_f, enc_i):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    dec = np.asarray(delta_decode_device(*map(np.asarray, enc_i)))
    np.testing.assert_array_equal(dec.astype(np.float32), F)


def test_integral_int16able():
    from degnorm_jax.data.buckets import integral_int16able
    rng = np.random.default_rng(3)
    mats = [np.round(random_coverage(rng, 3, 200)).astype(np.float32)
            for _ in range(10)]
    assert integral_int16able(mats)
    assert integral_int16able([m.astype(np.int32) for m in mats])
    assert not integral_int16able(mats + [mats[0] + 0.5])
    assert not integral_int16able(mats + [mats[0] * 1e5])


def test_rejects_lossy_cases():
    F = np.ones((2, 2, 8), np.float32)
    assert delta_encode(F + 0.25) is None     # non-integral
    assert delta_encode(F * 40000) is None    # exceeds int16
    jumpy = np.minimum(np.arange(2 * 2 * 64, dtype=np.float32)
                       .reshape(2, 2, 64) * 300, 30000)
    assert delta_encode(jumpy) is None        # >2% exception rate


def _random_int16_bucket(rng, G, p, W, n_real=None, jumpy_frac=0.001):
    """Pileup-like int16 bucket: smooth rows with sparse large jumps."""
    F = np.zeros((G, p, W), np.int16)
    for g in range(n_real if n_real is not None else G):
        base = np.cumsum(rng.integers(-2, 3, size=W))
        base -= base.min()
        F[g] = np.clip(base[None, :] + rng.integers(0, 3, (p, W)),
                       0, 32000).astype(np.int16)
        jumps = rng.random((p, W)) < jumpy_frac
        F[g][jumps] = rng.integers(0, 30000, int(jumps.sum()))
    return F


def test_nibble_roundtrip_lossless():
    from degnorm_jax.data.encode import nib_decode_device, nibble_encode
    rng = np.random.default_rng(11)
    for W in (9, 16, 257):                    # odd + even delta counts
        F = _random_int16_bucket(rng, 5, 3, W, n_real=4)
        enc = nibble_encode(F, n_real=4)
        assert enc is not None
        dec = np.asarray(nib_decode_device(
            enc.first, enc.nib, enc.exc_idx, enc.exc_val, enc.Wm1))
        np.testing.assert_array_equal(dec, F)
    # nibble form is ~quarter of the int16 bytes
    nbytes = enc.first.nbytes + enc.nib.nbytes + enc.exc_idx.nbytes \
        + enc.exc_val.nbytes
    assert nbytes < 0.30 * F.nbytes


def test_nibble_native_matches_numpy():
    from degnorm_jax.data.encode import nibble_encode, nibble_encode_native
    from degnorm_jax.io.native.build import load_library
    if load_library() is None:
        import pytest
        pytest.skip("native library unavailable")
    rng = np.random.default_rng(12)
    for G, p, W, n_real in ((7, 4, 33, 5), (64, 2, 128, 64), (3, 8, 9, 0)):
        F = _random_int16_bucket(rng, G, p, W, n_real=n_real)
        a = nibble_encode(F, n_real=n_real)
        b = nibble_encode_native(F, n_real=n_real, threads=3)
        assert a is not None and b is not None
        np.testing.assert_array_equal(a.first, b.first)
        np.testing.assert_array_equal(a.nib, b.nib)
        np.testing.assert_array_equal(a.exc_idx, b.exc_idx)
        np.testing.assert_array_equal(a.exc_val, b.exc_val)
        assert a.Wm1 == b.Wm1


def test_encode_coverage_dispatch():
    from degnorm_jax.data.encode import (DeltaEncoded, NibEncoded,
                                         decode_coverage_device,
                                         encode_coverage)
    rng = np.random.default_rng(13)
    F = _random_int16_bucket(rng, 6, 3, 64, n_real=6)
    enc = encode_coverage(F, n_real=6)
    assert isinstance(enc, NibEncoded)
    np.testing.assert_array_equal(np.asarray(decode_coverage_device(enc)), F)
    # jumpy-but-int8-able data: nibble over its exception cap, int8 fine
    Fj = np.cumsum(rng.integers(-60, 61, size=(4, 2, 512)), axis=2)
    Fj = (Fj - Fj.min()).astype(np.int16)
    encj = encode_coverage(Fj, n_real=4)
    assert isinstance(encj, DeltaEncoded)
    np.testing.assert_array_equal(
        np.asarray(decode_coverage_device(encj)), Fj)
    # float32 integral input still takes the int8 path
    enc_f = encode_coverage(F.astype(np.float32), n_real=6)
    assert isinstance(enc_f, DeltaEncoded)


def test_native_pack_matches_numpy():
    """pack_buckets' native int16 cast-pack must equal the threaded numpy
    slice-assignment fill byte-for-byte."""
    import degnorm_jax.data.buckets as bk
    rng = np.random.default_rng(14)
    mats = [np.round(random_coverage(rng, 3, L)).astype(np.float32)
            for L in (70, 200, 130, 512, 64)]
    b_native = bk.pack_buckets(mats, bucket_widths=(256, 1024),
                               dtype=np.int16)
    orig = bk._pack_i16_native
    bk._pack_i16_native = lambda *a, **k: False
    try:
        b_numpy = bk.pack_buckets(mats, bucket_widths=(256, 1024),
                                  dtype=np.int16)
    finally:
        bk._pack_i16_native = orig
    assert len(b_native) == len(b_numpy)
    for a, b in zip(b_native, b_numpy):
        np.testing.assert_array_equal(a.F, b.F)
        np.testing.assert_array_equal(a.lengths, b.lengths)
        np.testing.assert_array_equal(a.gene_indices, b.gene_indices)


def test_engine_delta_path_matches_direct():
    from collections import OrderedDict
    from degnorm_jax.config import EngineConfig, NMFConfig
    from degnorm_jax.engine import DegNormEngine
    import degnorm_jax.engine as eng_mod

    rng = np.random.default_rng(9)
    cov = OrderedDict(
        (f"g{i}", np.round(random_coverage(rng, 3, L, degraded=i % 2 == 0)))
        for i, L in enumerate((300, 500, 260, 410)))
    X = np.round(np.abs(rng.standard_normal((4, 3))) * 150 + 30)
    cfg = NMFConfig(nmf_iter=6, degnorm_iter=2)

    r1 = DegNormEngine(cfg, EngineConfig()).run(cov, X.copy())

    # force the direct (non-delta) upload path
    import degnorm_jax.data.encode as enc_mod
    orig = enc_mod.encode_coverage
    enc_mod.encode_coverage = lambda F, n_real=None: None
    try:
        r2 = DegNormEngine(cfg, EngineConfig()).run(cov, X.copy())
    finally:
        enc_mod.encode_coverage = orig
    np.testing.assert_array_equal(r1.rho, r2.rho)
    np.testing.assert_array_equal(r1.x_adj, r2.x_adj)


def test_bucket_byte_cap_respects_quantization():
    """A byte-capped bucket must not quantize back up past the cap (the
    engine's HBM guard sizes buckets by this cap)."""
    from degnorm_jax.data.buckets import pack_buckets
    rng = np.random.default_rng(15)
    mats = [np.round(random_coverage(rng, 2, 100)).astype(np.float32)
            for _ in range(500)]
    p, w, item = 2, 128, 4
    for cap_genes in (100, 150, 37):
        bs = pack_buckets(mats, bucket_widths=(128,), dtype=np.int16,
                          max_bucket_bytes=cap_genes * p * w * item,
                          budget_itemsize=item)
        assert all(b.F.shape[0] <= cap_genes for b in bs), \
            [(cap_genes, b.F.shape) for b in bs]
        assert sum(b.n_real for b in bs) == len(mats)


def test_engine_rejects_zero_iterations():
    from collections import OrderedDict
    from degnorm_jax.config import NMFConfig
    from degnorm_jax.engine import DegNormEngine
    import pytest
    cov = OrderedDict(g0=np.ones((2, 64)))
    with pytest.raises(ValueError, match="degnorm_iter"):
        DegNormEngine(NMFConfig(nmf_iter=2, degnorm_iter=0)).run(
            cov, np.ones((1, 2)))
