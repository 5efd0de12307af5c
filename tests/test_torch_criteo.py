"""Port parity for the Criteo readers: read_criteo and read_criteo_native
over a TSV the test writes (empty fields, hex and non-hex tokens, short
rows, a final line without a newline, a short last batch) give batches
bit-equal to the JAX package's readers, and the token hash equals the
JAX one on tokens whose 64-bit arithmetic wraps."""
import numpy as np
import pytest

from deeprec_tpu.data import criteo as jcriteo

from deeprec_tpu_torch.data import criteo as tcriteo
from deeprec_tpu_torch.utils import native as tnative

ROWS, BS = 45, 8


def _write_tsv(path, seed=0):
    rng = np.random.default_rng(seed)
    lines = []
    for i in range(ROWS):
        f = [str(int(rng.integers(0, 2)))]
        for _ in range(13):
            f.append("" if rng.random() < 0.2 else str(int(rng.integers(
                -5, 1000))))
        for _ in range(26):
            r = rng.random()
            f.append("" if r < 0.15 else
                     f"{int(rng.integers(0, 1 << 32)):08x}" if r < 0.9 else
                     "tok_" + str(int(rng.integers(0, 99))))
        if i % 11 == 5:   # a short row: the missing fields read as empty
            f = f[:20]
        lines.append("\t".join(f))
    with open(path, "w") as fh:
        fh.write("\n".join(lines))  # no newline after the last line


def _assert_batches_equal(got, ref):
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        assert sorted(g) == sorted(r)
        for k in r:
            assert g[k].dtype == r[k].dtype, k
            np.testing.assert_array_equal(g[k], r[k], err_msg=k)


@pytest.mark.parametrize("drop", [True, False], ids=["drop", "pad"])
def test_read_criteo_matches_jax(tmp_path, drop):
    path = str(tmp_path / "day.tsv")
    _write_tsv(path)
    got = list(tcriteo.read_criteo(path, BS, num_epochs=2,
                                   drop_remainder=drop))
    ref = list(jcriteo.read_criteo(path, BS, num_epochs=2,
                                   drop_remainder=drop))
    _assert_batches_equal(got, ref)
    # 45 rows an epoch: 5 full batches, and a padded sixth without drop
    assert len(got) == 2 * (5 if drop else 6)
    # empty tokens read as the missing id, -2
    assert any((b[f"C{i}"] == -2).any() for b in got for i in range(1, 27))


def test_read_criteo_native_matches_jax(tmp_path):
    """The port's C++ parser (its own build of the shared source) against
    the JAX package's Python reader: the same bytes give the same ids."""
    if tnative.get_lib() is None:
        pytest.skip("no C++ compiler for the native parser")
    path = str(tmp_path / "day.tsv")
    _write_tsv(path, seed=1)
    got = list(tcriteo.read_criteo_native(path, BS, chunk_bytes=777))
    ref = list(jcriteo.read_criteo(path, BS))
    _assert_batches_equal(got, ref)
    assert len(got) == ROWS // BS


def test_hash_token_wraps_as_jax():
    toks = ["", "0", "68fd1e64", "ffffffffffffffff", "tok_" + "z" * 200,
            "été"]
    for t in toks:
        assert tcriteo._hash_token(t) == jcriteo._hash_token(t), t
    for x in (0, 1, (1 << 64) - 1, 0x9E3779B97F4A7C15):
        assert tcriteo._mix64(x) == jcriteo._mix64(x)
