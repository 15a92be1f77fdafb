"""PyTorch port vs JAX package: topology and pencil metadata, and the
port's import boundary.

Range and size tables need no ranks: a port ``Topology`` built without
``torch.distributed`` answers every metadata query.  Every accessor, in
both index orders and for every block, must equal the JAX package's.
"""

import ast
import itertools
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import pencilarrays_tpu as jpa
import pencilarrays_tpu_torch as pat

ROOT = Path(__file__).resolve().parent.parent


@pytest.mark.parametrize("ndims", [1, 2, 3])
def test_dims_create_matches_jax(ndims):
    from pencilarrays_tpu.parallel.topology import dims_create as jax_dc

    for n in range(1, 65):
        assert pat.dims_create(n, ndims) == jax_dc(n, ndims)


def test_permutation_algebra_matches_jax():
    for p, q in itertools.product(itertools.permutations(range(3)),
                                  repeat=2):
        a, b = pat.Permutation(p), pat.Permutation(q)
        ja, jb = jpa.Permutation(p), jpa.Permutation(q)
        t = ("x", "y", "z")
        assert a.apply(t) == ja.apply(t)
        assert a.invapply(t) == ja.invapply(t)
        assert (a * b).indices == (ja * jb).indices
        assert (a / b).indices == (ja / jb).indices
        assert a.append(2).indices == ja.append(2).indices
        assert a.is_identity() == ja.is_identity()


PENCILS = [
    ((2, 4), (42, 31, 29), None, None),
    ((2, 4), (16, 16, 16), (0, 2), (2, 0, 1)),
    ((2, 4), (7, 12, 13), (2, 1), (1, 2, 0)),
    ((2, 2), (9, 16, 9), (1, 0), (0, 2, 1)),
    ((2, 2), (5, 3, 2), (0, 1), (2, 1, 0)),
    ((8,), (21, 17, 14), (1,), None),
    ((2, 4), (8, 8), None, (1, 0)),
    ((2, 4), (6, 7, 8, 9), (1, 3), (3, 0, 1, 2)),
    ((4,), (3, 1, 5), (1,), None),
]


@pytest.mark.parametrize("dims,shape,decomp,perm", PENCILS)
def test_pencil_tables_match_jax(devices, dims, shape, decomp, perm):
    jtopo = jpa.Topology(dims, devices=devices[:int(np.prod(dims))])
    ptopo = pat.Topology(dims, device="cpu")
    jp = jpa.Pencil(jtopo, shape, decomp,
                    permutation=None if perm is None else jpa.Permutation(perm))
    pp = pat.Pencil(ptopo, shape, decomp,
                    permutation=None if perm is None else pat.Permutation(perm))
    assert pp.decomposition == jp.decomposition
    assert pp.padded_global_shape == jp.padded_global_shape
    for jo, po in ((jpa.LogicalOrder, pat.LogicalOrder),
                   (jpa.MemoryOrder, pat.MemoryOrder)):
        assert pp.size_global(po) == jp.size_global(jo)
        assert pp.padded_size_global(po) == jp.padded_size_global(jo)
        assert pp.padded_size_local(po) == jp.padded_size_local(jo)
        for rank in range(len(ptopo)):
            c = ptopo.coords(rank)
            assert c == jtopo.coords(rank)
            assert ptopo.rank(c) == jtopo.rank(c)
            assert pp.range_local(c, po) == jp.range_local(c, jo)
            assert pp.range_remote(rank, po) == jp.range_remote(rank, jo)
            assert pp.size_local(c, po) == jp.size_local(c, jo)
            assert pp.length_local(c) == jp.length_local(c)
            first = tuple(r.start for r in jp.range_local(c, jo))
            assert pp.to_local(first, c, po) == jp.to_local(first, c, jo)
    assert pp.axes_all.tolist() == jp.axes_all.tolist()
    assert np.array_equal(ptopo.ranks, jtopo.ranks)
    for d in range(len(shape)):
        assert pp.proc_count(d) == jp.proc_count(d)
        assert pp.decomp_axis_name(d) == jp.decomp_axis_name(d)
    assert pp.length_global() == jp.length_global()
    assert pp.replace(decomp_dims=None).decomposition == jp.decomposition


def test_local_data_range_matches_jax():
    for n, P in itertools.product(range(0, 20), range(1, 9)):
        for p in range(P):
            assert pat.local_data_range(p, P, n) == jpa.local_data_range(p, P, n)


@pytest.mark.parametrize("ndims,decomp,vals,fill", [
    (3, (1, 2), (4, 5), 1), (4, (0,), (7,), 2), (3, (), (), 0),
    (5, (4, 0, 2), (3, 1, 9), 1)])
def test_complete_dims_matches_jax(ndims, decomp, vals, fill):
    """``tests/test_pencils.py::test_complete_dims``'s cases and more."""
    from pencilarrays_tpu.parallel.pencil import complete_dims as jax_cd
    from pencilarrays_tpu_torch.parallel.pencil import complete_dims

    assert complete_dims(ndims, decomp, vals, fill) == jax_cd(
        ndims, decomp, vals, fill)


@pytest.mark.parametrize("shape,ndims_decomp", [
    ((42, 31, 29), None), ((8, 9, 10, 11), 2), ((12, 7), None)])
def test_make_pencil_matches_jax(devices, shape, ndims_decomp):
    """Without torch.distributed the port's topology has one rank; the
    JAX package given one device must choose the same pencil."""
    pp = pat.make_pencil(shape, ndims_decomp, device="cpu")
    jp = jpa.make_pencil(shape, ndims_decomp, devices=devices[:1])
    assert pp.topology.dims == jp.topology.dims
    assert pp.decomposition == jp.decomposition
    assert pp.padded_size_local(pat.MemoryOrder) == jp.padded_size_local(
        jpa.MemoryOrder)


def test_topology_defaults_to_the_card():
    """Without ``device=`` the topology lives on CUDA, and asking for CUDA
    where there is none raises (never a silent CPU fallback)."""
    if torch.cuda.is_available():
        assert pat.Topology((1,)).device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        pat.Topology((1,))
    with pytest.raises(RuntimeError, match="CUDA"):
        pat.Topology((1,), device="cuda")
    assert pat.Topology((1,), device="cpu").device.type == "cpu"


def test_port_imports_without_jax():
    """The port imports with JAX and the JAX package made unimportable."""
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['pencilarrays_tpu'] = None\n"
        "import pencilarrays_tpu_torch, pencilarrays_tpu_torch.models\n"
        "import pencilarrays_tpu_torch.interop\n"
        "import pencilarrays_tpu_torch.ops.permute\n"
        "import pencilarrays_tpu_torch.ops._build\n"
        "import pencilarrays_tpu_torch.numpy, pencilarrays_tpu_torch.compat\n"
        "import pencilarrays_tpu_torch.models.heat_fd\n"
        "import pencilarrays_tpu_torch.models.ode\n"
        "import pencilarrays_tpu_torch.parallel.multiarrays\n"
        "import pencilarrays_tpu_torch.parallel.wire\n"
        "import pencilarrays_tpu_torch.parallel.routing\n"
        "import pencilarrays_tpu_torch.analysis\n"
        "import pencilarrays_tpu_torch.utils.timers\n"
        "assert not any(m == 'jax' or m.startswith(('jax.', 'jaxlib'))\n"
        "               for m in sys.modules if sys.modules[m] is not None)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_no_port_module_imports_jax():
    files = sorted((ROOT / "pencilarrays_tpu_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 10
    for path in files:
        for mod in _imported_modules(path):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "pencilarrays_tpu"), (
                f"{path.relative_to(ROOT)} imports {mod}")
