"""PyTorch port vs JAX package: parallel I/O (``io/``).

The cases of ``tests/test_io.py`` (its Orbax cases aside) run on the
port's CPU path over 1, 2 and 4 gloo ranks of one pool
(``torch_rank_tasks.io_case``): round trips, the on-disk layout read back
from raw bytes, append, decomposition-independent restart, the chunks
layout, extra dims, metadata-less reads, rewrite region reuse,
collections, the memmap path and the HDF5 driver.  Each rank writes and
reads its own block; data movement is bit-identical, with no tolerance.

Files cross between the packages, which is the parity test: the JAX
package on the 8-device CPU mesh writes a binary file, an HDF5 file and a
checkpoint, and the port reads them on 1, 2 and 4 ranks under another
decomposition and memory order, bit for bit; then the port writes, and
the JAX package reads and verifies.  The port's sidecars, manifests and
HDF5 attributes equal those the JAX package writes for the same pencil.
"""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pencilarrays_tpu as jpa
import pencilarrays_tpu.io as jio
from pencilarrays_tpu.cluster import epoch as jax_epoch
from pencilarrays_tpu.resilience import CheckpointManager as JaxManager
import torch_rank_tasks as tasks
from pencilarrays_tpu_torch.io import native

SHAPE = tasks.IO_SHAPE
DIMS = [(1, 1), (1, 2), (2, 2)]
DIM_IDS = ["x".join(map(str, d)) for d in DIMS]


@pytest.fixture(scope="module")
def pool():
    return tasks.shared_pool()


def _bits(a):
    a = np.ascontiguousarray(a)
    return a.view(np.uint16) if a.dtype.name in ("bfloat16", "int16") else a


def _same(a, b):
    a, b = _bits(a), _bits(b)
    assert a.shape == b.shape and a.dtype == b.dtype, (a.dtype, b.dtype)
    assert np.array_equal(a.view(np.uint8), b.view(np.uint8))


@pytest.mark.parametrize("dims", DIMS, ids=DIM_IDS)
@pytest.mark.parametrize("case", sorted(tasks._IO_CASES))
def test_io_case(pool, tmp_path, dims, case):
    if case.startswith("h5_"):
        pytest.importorskip("h5py")
    pool.run(tasks.io_case, dims, case, str(tmp_path))


@pytest.mark.parametrize("dims", DIMS, ids=DIM_IDS)
def test_write_stats_name_the_native_path(pool, tmp_path, dims):
    """A write reports its stages and the path the bytes took: the native
    library, built from ``native/pa_io.cpp`` by the port itself."""
    stats = pool.run(tasks.io_case, dims, "roundtrip", str(tmp_path))[0]
    assert stats["path"] == "native_mt(1)"
    assert {"k1_s", "d2h_s", "write_s", "fsync_s", "meta_s"} <= set(stats)


# -- the native library ---------------------------------------------------

def test_native_builds_into_the_port(tmp_path):
    assert native.available()
    lib = native.build_info["path"]
    assert os.path.dirname(lib).endswith(
        os.path.join("pencilarrays_tpu_torch", "io", "_build"))


def test_native_strided_io_direct(tmp_path):
    """The C++ scatter/gather against NumPy ground truth."""
    gdims = (7, 9, 5)
    full = np.zeros(gdims, dtype=np.float64)
    path = str(tmp_path / "raw.bin")
    with open(path, "wb") as f:
        f.write(full.tobytes())
    rng = np.random.default_rng(0)
    blocks = [((1, 2, 0), rng.standard_normal((3, 4, 5))),
              ((4, 6, 1), rng.standard_normal((3, 3, 4)))]
    for start, b in blocks:
        native.scatter_write(path, 0, b, gdims, start)
        full[tuple(slice(s, s + e) for s, e in zip(start, b.shape))] = b
    raw = np.fromfile(path, dtype=np.float64).reshape(gdims)
    np.testing.assert_array_equal(raw, full)
    got = native.gather_read(path, 0, np.float64, gdims, (2, 3, 1), (4, 5, 3))
    np.testing.assert_array_equal(got, full[2:6, 3:8, 1:4])
    into = np.empty((4, 5, 3))
    assert native.gather_read(path, 0, np.float64, gdims, (2, 3, 1),
                              (4, 5, 3), out=into) is into
    np.testing.assert_array_equal(into, full[2:6, 3:8, 1:4])
    with pytest.raises(ValueError, match="C-contiguous"):
        native.gather_read(path, 0, np.float64, gdims, (2, 3, 1), (4, 5, 3),
                           out=np.empty((4, 5, 3), np.float32))
    with pytest.raises(OSError):
        native.gather_read(path, 0, np.float64, gdims, (5, 0, 0), (4, 1, 1))


@pytest.mark.parametrize("gdims,start,bdims", [
    ((6, 8, 10), (2, 0, 0), (3, 8, 10)),      # trailing dims coalesce
    ((16, 12, 9), (3, 2, 1), (9, 7, 5)),      # interior block
    ((10, 10, 6), (1, 2, 0), (4, 5, 6)),      # only the last dim complete
    ((40, 30), (8, 5), (20, 11)),             # 2-D
    ((48, 256, 300), (5, 3, 100), (40, 250, 150)),   # threads spawn
])
def test_native_multithreaded_and_coalesced(tmp_path, gdims, start, bdims):
    rng = np.random.default_rng(3)
    path = str(tmp_path / "mt.bin")
    full = rng.standard_normal(gdims)
    with open(path, "wb") as f:
        f.write(full.tobytes())
    patch = rng.standard_normal(bdims)
    native.scatter_write(path, 0, patch, gdims, start, nthreads=8)
    full[tuple(slice(s, s + e) for s, e in zip(start, bdims))] = patch
    raw = np.fromfile(path, dtype=np.float64).reshape(gdims)
    np.testing.assert_array_equal(raw, full)
    got = native.gather_read(path, 0, np.float64, gdims, start, bdims,
                             nthreads=8)
    np.testing.assert_array_equal(got, patch)


def test_io_threads_env(monkeypatch):
    monkeypatch.delenv("PENCILARRAYS_TPU_IO_THREADS", raising=False)
    assert native.default_threads() == 1
    monkeypatch.setenv("PENCILARRAYS_TPU_IO_THREADS", "6")
    assert native.default_threads() == 6
    monkeypatch.setenv("PENCILARRAYS_TPU_IO_THREADS", "99")
    assert native.default_threads() == 16


def test_orbax_is_not_ported(tmp_path, devices):
    """The Orbax driver is ported on TensorStore alone: files cross both
    ways with the JAX package's Orbax driver (f64, f32 with an extra dim,
    a collection, bfloat16; synchronous and async writes), each read back
    bit for bit under another decomposition and memory order."""
    import pencilarrays_tpu_torch as pat
    from pencilarrays_tpu_torch.io import OrbaxDriver, has_orbax, open_file

    assert has_orbax() is True
    if not jio.has_orbax():
        pytest.skip("the JAX package's Orbax driver needs orbax")
    data = {n: u for n, u in _dataset_arrays().items() if n != "c"}
    jpen = _jax_pencil((2, 4), WRITER, devices)
    jread = _jax_pencil((1, 1), READER, devices)
    ptopo = pat.Topology((1, 1), device="cpu")

    def ppen(spec):
        decomp, perm = spec
        return pat.Pencil(ptopo, SHAPE, decomp,
                          permutation=pat.Permutation(*perm))

    def parr(pen, u):
        if isinstance(u, tuple):
            return tuple(parr(pen, c) for c in u)
        t = torch.from_numpy(np.ascontiguousarray(u).view(np.uint16)).view(
            torch.bfloat16) if u.dtype.name == "bfloat16" else u
        return pat.PencilArray.from_global(pen, t)

    def pget(x):
        g = pat.gather(x)
        if x.dtype == torch.bfloat16 and g.dtype != np.uint16:
            # the gathered values (exact in bf16) as bf16 bit patterns
            g = torch.from_numpy(np.ascontiguousarray(g)).to(
                torch.bfloat16).view(torch.int16).numpy().view(np.uint16)
        return g

    def jarr(pen, u):
        if isinstance(u, tuple):
            return tuple(jarr(pen, c) for c in u)
        return jpa.PencilArray.from_global(pen, u)

    for async_write in (False, True):
        # the JAX package writes, the port reads
        jdir = str(tmp_path / f"jax{int(async_write)}")
        with jio.open_file(jio.OrbaxDriver(async_write=async_write), jdir,
                           write=True, create=True) as f:
            for n, u in data.items():
                f.write(n, jarr(jpen, u))
        with open_file(OrbaxDriver(), jdir, read=True) as f:
            assert f.datasets() == sorted(data)
            for n, u in data.items():
                got = f.read(n, ppen(READER))
                for g, want in zip(got if isinstance(got, tuple) else (got,),
                                   u if isinstance(u, tuple) else (u,)):
                    _same(pget(g), want)
        # the port writes, the JAX package reads (and its sidecars match)
        pdir = str(tmp_path / f"port{int(async_write)}")
        with open_file(OrbaxDriver(async_write=async_write), pdir,
                       write=True, create=True) as f:
            for n, u in data.items():
                f.write(n, parr(ppen(WRITER), u))
        with jio.open_file(jio.OrbaxDriver(), pdir, read=True) as f:
            for n, u in data.items():
                got = f.read(n, jread)
                for g, want in zip(got if isinstance(got, tuple) else (got,),
                                   u if isinstance(u, tuple) else (u,)):
                    _same(np.asarray(jpa.gather(g)), want)
        for n in data:
            with open(os.path.join(pdir, n + ".meta.json")) as f:
                pm = json.load(f)
            with open(os.path.join(jdir, n + ".meta.json")) as f:
                jm = json.load(f)
            assert set(pm) == set(jm) and pm["dtype"] == jm["dtype"]
            assert pm["dims_logical"] == jm["dims_logical"]
            assert {k: v for k, v in pm["metadata"].items()
                    if k != "process_dims"} == \
                {k: v for k, v in jm["metadata"].items()
                 if k != "process_dims"}


def test_orbax_checkpoints_cross_with_checksums_off(tmp_path, devices):
    """The Orbax half of the JAX package's
    ``test_checksums_off_validates_chunks_and_orbax_layouts``, both ways:
    an Orbax-driver checkpoint with structural verification saved by one
    package verifies and restores in the other."""
    import pencilarrays_tpu_torch as pat
    from pencilarrays_tpu_torch.io import OrbaxDriver
    from pencilarrays_tpu_torch.resilience import CheckpointManager

    if not jio.has_orbax():
        pytest.skip("the JAX package's Orbax driver needs orbax")
    u = np.random.default_rng(21).standard_normal(SHAPE)
    jpen = _jax_pencil((2, 4), WRITER, devices)
    ptopo = pat.Topology((1, 1), device="cpu")
    ppen = pat.Pencil(ptopo, SHAPE, READER[0],
                      permutation=pat.Permutation(*READER[1]))
    JaxManager(str(tmp_path / "jax"), driver=jio.OrbaxDriver(),
               checksums=False).save(0, {"u": jpa.PencilArray.from_global(
                   jpen, u)})
    mgr = CheckpointManager(str(tmp_path / "jax"), driver=OrbaxDriver(),
                            checksums=False)
    assert mgr.latest_valid() == 0
    _same(pat.gather(mgr.restore().read("u", ppen)), u)
    with pytest.raises(ValueError, match="checksums"):
        CheckpointManager(str(tmp_path / "x"), driver=OrbaxDriver())
    CheckpointManager(str(tmp_path / "port"), driver=OrbaxDriver(),
                      checksums=False).save(
        0, {"u": pat.PencilArray.from_global(ppen, u)})
    jm = JaxManager(str(tmp_path / "port"), driver=jio.OrbaxDriver(),
                    checksums=False)
    assert jm.latest_valid() == 0
    _same(np.asarray(jpa.gather(jm.restore().read("u", jpen))), u)


# -- files cross between the packages -------------------------------------

WRITER = tasks.IO_WRITER
READER = tasks.IO_READER


def _jax_pencil(dims, spec, devices):
    n = int(np.prod(dims))
    topo = jpa.Topology(dims, devices=devices[:n])
    decomp, perm = spec
    return jpa.Pencil(topo, SHAPE, decomp, permutation=None if perm is None
                      else jpa.Permutation(*perm))


def _dataset_arrays():
    """The datasets both packages write: f64, f32 with an extra dim, a
    collection, the chunks layout and bfloat16."""
    rng = np.random.default_rng(5)
    return {
        "u": rng.standard_normal(SHAPE),
        "v": rng.standard_normal(SHAPE + (2,)).astype(np.float32),
        "s": (rng.standard_normal(SHAPE), rng.standard_normal(SHAPE)),
        "c": rng.standard_normal(SHAPE),
        "b": rng.standard_normal(SHAPE).astype(jnp.bfloat16),
    }


def _jax_write(directory, pen, data):
    """The JAX package's binary file, HDF5 file and checkpoint of
    ``data`` on ``pen``."""
    def arr(u):
        return jpa.PencilArray.from_global(pen, u)

    xs = {n: tuple(arr(c) for c in u) if isinstance(u, tuple) else arr(u)
          for n, u in data.items()}
    with jio.open_file(jio.BinaryDriver(), str(directory / "jax.bin"),
                       write=True, create=True) as f:
        for n, x in xs.items():
            f.write(n, x, chunks=n.startswith("c"))
    with jio.open_file(jio.HDF5Driver(), str(directory / "jax.h5"),
                       write=True, create=True) as f:
        for n, x in xs.items():
            if not n.startswith("c"):
                f.write(n, x)
    JaxManager(str(directory / "ckpt")).save(
        1, {n: x for n, x in xs.items() if not n.startswith("c")})


def _flat(data):
    out = {}
    for n, u in data.items():
        if isinstance(u, tuple):
            out.update({f"{n}[{i}]": c for i, c in enumerate(u)})
        else:
            out[n] = u
    return out


@pytest.fixture(scope="module")
def jax_files(tmp_path_factory, devices):
    pytest.importorskip("h5py")
    d = tmp_path_factory.mktemp("jax_io")
    data = _dataset_arrays()
    _jax_write(d, _jax_pencil((2, 4), WRITER, devices), data)
    return d, _flat(data)


@pytest.mark.parametrize("dims", DIMS, ids=DIM_IDS)
def test_jax_files_read_by_port(pool, jax_files, dims):
    """The port reads the JAX package's binary datasets (every layout and
    dtype), HDF5 datasets and checkpoint, on 1, 2 and 4 ranks under
    another decomposition and memory order, bit for bit, verifying the
    checkpoint in full and locally."""
    d, want = jax_files
    got = pool.run(tasks.io_cross_read, dims, str(d), READER)[0]
    keys = {f"bin:{n}" for n in want}
    keys |= {f"h5:{n}" for n in want if not n.startswith("c")}
    keys |= {f"ckpt1{v}:{n}" for n in want if not n.startswith("c")
             for v in ("", "local")}
    assert set(got) == keys
    for key, value in got.items():
        _same(value, want[key.split(":")[1]])


def _port_write(pool, dims, d, data):
    bits = {n: (np.ascontiguousarray(u).view(np.uint16)
                if np.asarray(u).dtype.name == "bfloat16" else u)
            for n, u in data.items()}
    pool.run(tasks.io_cross_write, dims, str(d), WRITER, bits, ("b",))


@pytest.mark.parametrize("dims", DIMS, ids=DIM_IDS)
def test_port_files_read_by_jax(pool, tmp_path, devices, dims, monkeypatch):
    """The JAX package reads and verifies what the port wrote on 1, 2 and
    4 ranks, bit for bit, on its 8-device mesh under another pencil; the
    port's sidecar and manifest equal, key by key, the ones the JAX
    package writes for the same pencil, and so do the HDF5 attributes."""
    pytest.importorskip("h5py")
    data = _dataset_arrays()
    want = _flat(data)
    port = tmp_path / "port"
    port.mkdir()
    _port_write(pool, dims, port, data)
    pen = _jax_pencil((2, 4), READER, devices)
    with jio.open_file(jio.BinaryDriver(), str(port / "port.bin"),
                       read=True) as f:
        for n, u in data.items():
            back = f.read(n, pen)
            for i, b in enumerate(back if isinstance(back, tuple)
                                  else (back,)):
                _same(jpa.gather(b),
                      want[f"{n}[{i}]" if isinstance(back, tuple) else n])
    with jio.open_file(jio.HDF5Driver(), str(port / "port.h5"),
                       read=True) as f:
        assert f.datasets() == ["b", "s", "u", "v"]
        for n in ("u", "v", "b"):
            _same(jpa.gather(f.read(n, pen)), want[n])
    mgr = JaxManager(str(port / "ckpt"))
    mgr.verify(1)
    assert mgr.latest_valid() == 1
    ck = mgr.restore(1)
    assert ck.datasets == ["b", "s", "u", "v"]
    for n in ("u", "v", "b"):
        _same(jpa.gather(ck.read(n, pen, verify=True)), want[n])

    ref = tmp_path / "jax"
    ref.mkdir()
    # the manifest's recovery epoch: 0 in the port, and in a JAX process
    # whose cluster layer never recovered (another test may have moved it)
    monkeypatch.setattr(jax_epoch, "_epoch", 0)
    _jax_write(ref, _jax_pencil(dims, WRITER, devices), data)
    with open(port / "port.bin.json") as a, open(ref / "jax.bin.json") as b:
        assert json.load(a) == json.load(b)
    step = os.path.join("step-00000001", "MANIFEST.json")
    with open(port / "ckpt" / step) as a, open(ref / "ckpt" / step) as b:
        assert json.load(a) == json.load(b)
    with jio.open_file(jio.HDF5Driver(), str(port / "port.h5"),
                       read=True) as f, \
            jio.open_file(jio.HDF5Driver(), str(ref / "jax.h5"),
                          read=True) as g:
        for n in ("u", "v", "s", "b"):
            assert f.attributes(n) == g.attributes(n)
