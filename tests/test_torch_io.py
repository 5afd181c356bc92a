"""PyTorch port: matrix IO (``matrel_tpu_torch/io.py``) and its native
readers (``utils/native.py`` over ``native/mtx_reader.cc``, built into
``build/native/libmatrel_ingest.so``) held against the JAX package's
``matrel_tpu/io.py`` on the same files, written from seeded numpy data:
.npy, MatrixMarket (general, symmetric, skew-symmetric, pattern and
array, and a complex file that falls back to scipy), "i,j[,value]" CSV,
and the tiled directory format; plus the scipy / numpy fallbacks when
the native library is unavailable.

Every loaded matrix is compared exactly (each format stores the values
it is given, and both packages cast once to f32): ``assert_array_equal``
against the JAX package's result and the numpy source.
"""

import os

import jax
import numpy as np
import pytest
import scipy.io
import scipy.sparse as sps

from matrel_tpu import io as jio
from matrel_tpu.core import mesh as jmesh_lib

from matrel_tpu_torch import io as tio
from matrel_tpu_torch.core.mesh import make_mesh
from matrel_tpu_torch.utils import native

from test_torch_native_guard import ensure_reference_native

# the JAX package's native library, whole and loaded in this process
ensure_reference_native()

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def meshes():
    return (jmesh_lib.make_mesh((1, 1), devices=jax.devices()[:1]),
            make_mesh(device="cpu"))


@pytest.fixture(params=["native", "fallback"])
def reader(request, monkeypatch):
    """Run a test with the native readers, then with them unavailable
    (the scipy / numpy fallbacks)."""
    if request.param == "fallback":
        monkeypatch.setattr(native, "load_ingest", lambda: None)
    else:
        assert native.load_ingest() is not None, "g++ is present here"
    return request.param


def _write_mtx(path, text):
    with open(path, "w") as f:
        f.write(text)
    return str(path)


MTX = {
    "general": ("%%MatrixMarket matrix coordinate real general\n"
                "% a comment\n5 4 4\n1 1 1.5\n2 3 -2.25\n5 4 3e-2\n"
                "2 3 1.0\n"),
    "symmetric": ("%%MatrixMarket matrix coordinate real symmetric\n"
                  "4 4 3\n1 1 2.0\n3 1 -1.5\n4 2 0.5\n"),
    "skew": ("%%MatrixMarket matrix coordinate real skew-symmetric\n"
             "3 3 2\n2 1 4.0\n3 2 -1.0\n"),
    "pattern": ("%%MatrixMarket matrix coordinate pattern general\n"
                "3 5 3\n1 5\n2 2\n3 1\n"),
    "integer": ("%%MatrixMarket matrix coordinate integer general\n"
                "2 2 2\n1 2 7\n2 1 -3\n"),
    "array": ("%%MatrixMarket matrix array real general\n"
              "2 3\n1.0\n2.0\n3.0\n4.0\n5.0\n6.0\n"),
}


@pytest.mark.parametrize("kind", sorted(MTX))
def test_load_mtx_matches_jax(tmp_path, meshes, reader, kind):
    jm, tm = meshes
    p = _write_mtx(tmp_path / f"{kind}.mtx", MTX[kind])
    want = scipy.io.mmread(p)
    want = want.toarray() if sps.issparse(want) else np.asarray(want)
    t = tio.load_mtx(p, mesh=tm, block_size=4)
    tc = tio.load_mtx_coo(p)
    np.testing.assert_array_equal(t.to_numpy(), want.astype(np.float32))
    np.testing.assert_array_equal(tc.to_dense(), want.astype(np.float32))
    j = jio.load_mtx(p, mesh=jm, block_size=4)
    assert t.shape == tuple(j.shape) == want.shape
    np.testing.assert_array_equal(t.to_numpy(), np.asarray(j.to_numpy()))
    jc = jio.load_mtx_coo(p)
    assert tc.shape == tuple(jc.shape)
    np.testing.assert_array_equal(tc.to_dense(), jc.to_dense())


def test_complex_mtx_falls_back_to_scipy(tmp_path, meshes):
    """The native reader declines a complex field; scipy reads it (the
    JAX package's own fallback). Both packages keep the real part."""
    jm, tm = meshes
    p = _write_mtx(tmp_path / "c.mtx",
                   "%%MatrixMarket matrix coordinate complex general\n"
                   "2 2 2\n1 1 1.0 2.0\n2 2 3.0 -1.0\n")
    assert native.mtx_read(p) is None
    with np.errstate(all="ignore"):
        j = jio.load_mtx(p, mesh=jm, block_size=2)
        t = tio.load_mtx(p, mesh=tm, block_size=2)
    np.testing.assert_array_equal(t.to_numpy(), np.asarray(j.to_numpy()))


def test_native_reader_builds_in_the_port_build_dir():
    assert native.INGEST_LIB_PATH == os.path.join(
        REPO, "build", "native", "libmatrel_ingest.so")
    assert native.load_ingest() is not None
    assert os.path.exists(native.INGEST_LIB_PATH)
    assert not native._is_stale(native.INGEST_SOURCE,
                                native.INGEST_LIB_PATH)


def test_native_readers_refuse_what_they_cannot_parse(tmp_path):
    assert native.mtx_read(str(tmp_path / "missing.mtx")) is None
    bad = _write_mtx(tmp_path / "bad.mtx",
                     "%%MatrixMarket matrix coordinate real general\n"
                     "3 3 3\n1 1 1.0\n")          # truncated
    assert native.mtx_read(bad) is None
    assert native.coo_csv_read(str(tmp_path / "missing.csv")) is None


@pytest.mark.parametrize("with_values", [True, False])
def test_coo_csv_matches_jax(tmp_path, meshes, reader, with_values):
    jm, tm = meshes
    rng = np.random.default_rng(3)
    rows, cols = rng.integers(0, 9, 30), rng.integers(0, 7, 30)
    vals = rng.standard_normal(30).astype(np.float32)
    p = str(tmp_path / "e.csv")
    with open(p, "w") as f:
        for r, c, v in zip(rows, cols, vals):
            f.write(f"{r},{c},{v:.9g}\n" if with_values else f"{r},{c}\n")
    for got, want in zip(tio.read_edges_csv(p), jio.read_edges_csv(p)):
        np.testing.assert_array_equal(got, want)
    for dense in (True, False):
        j = jio.load_coo_csv(p, (9, 7), mesh=jm, block_size=4, dense=dense)
        t = tio.load_coo_csv(p, (9, 7), mesh=tm, block_size=4, dense=dense)
        np.testing.assert_array_equal(t.to_numpy(),
                                      np.asarray(j.to_numpy()))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_npy_round_trip(tmp_path, meshes, dtype):
    jm, tm = meshes
    a = np.random.default_rng(4).standard_normal((13, 9)).astype(np.float32)
    p = str(tmp_path / "a.npy")
    np.save(p, a)
    t = tio.load_npy(p, mesh=tm)
    j = jio.load_npy(p, mesh=jm)
    np.testing.assert_array_equal(t.to_numpy(), np.asarray(j.to_numpy()))
    from matrel_tpu_torch.core.blockmatrix import BlockMatrix
    m = BlockMatrix.from_numpy(a, mesh=tm, dtype=dtype)
    out = str(tmp_path / "b.npy")
    tio.save_npy(out, m)
    np.testing.assert_array_equal(np.load(out), m.to_numpy())


@pytest.mark.parametrize("tile", [4, 5, 64])
def test_tiled_round_trip_matches_jax(tmp_path, meshes, tile):
    jm, tm = meshes
    a = np.random.default_rng(5).standard_normal((17, 11)).astype(np.float32)
    from matrel_tpu.core.blockmatrix import BlockMatrix as JBM
    from matrel_tpu_torch.core.blockmatrix import BlockMatrix
    tio.save_tiled(str(tmp_path / "t"), BlockMatrix.from_numpy(a, mesh=tm),
                   tile=tile, workers=3)
    jio.save_tiled(str(tmp_path / "j"), JBM.from_numpy(a, mesh=jm),
                   tile=tile, workers=3)
    assert (sorted(os.listdir(tmp_path / "t"))
            == sorted(os.listdir(tmp_path / "j")))
    with open(tmp_path / "t" / "meta.json") as f, \
            open(tmp_path / "j" / "meta.json") as g:
        assert f.read() == g.read()
    back = tio.load_tiled(str(tmp_path / "j"), mesh=tm, workers=2)
    np.testing.assert_array_equal(back.to_numpy(), a)
    jback = jio.load_tiled(str(tmp_path / "t"), mesh=jm)
    np.testing.assert_array_equal(np.asarray(jback.to_numpy()), a)
