"""The port's checkpoints (utils/checkpoint.py) and field output
(utils/fieldio.py) against the JAX package's: a checkpoint written by one
package loads bitwise in the other and resumes the Taylor-Green demo, and
the VTU/PVD writers produce the same files for the same inputs (the spec
is tests/test_fieldio.py)."""
import numpy as np
import pytest
import torch

from iifea_tpu.mesh.core import FunctionSpace as JSpace
from iifea_tpu.mesh.generators import box_mesh, rectangle_mesh
from iifea_tpu.utils import checkpoint as jck
from iifea_tpu.utils import fieldio as jio
from iifea_tpu_torch.convert import from_numpy_state
from iifea_tpu_torch.demos import poisson as poisson_demo
from iifea_tpu_torch.demos import tg_vortex as tg_demo
from iifea_tpu_torch.mesh.core import FunctionSpace
from iifea_tpu_torch.utils import checkpoint as tck
from iifea_tpu_torch.utils import fieldio as tio


def _state(seed):
    rng = np.random.default_rng(seed)
    return {"up_p": rng.standard_normal(75),
            "up_old_f": rng.standard_normal(243),
            "ids": rng.integers(0, 9, 5).astype(np.int32)}


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_torch_checkpoint_across_packages(tmp_path, writer):
    """Saved by one package, loaded by the other: the same step, meta and
    arrays, bitwise; the newest checkpoint is the one 'latest' names, and
    an empty directory loads as None in both."""
    assert tck.load_checkpoint(str(tmp_path / "none"), device="cpu") is None
    assert jck.load_checkpoint(str(tmp_path / "none")) is None
    d = str(tmp_path / "ck")
    for step in (1, 2):
        st = _state(step)
        if writer == "jax":
            jck.save_checkpoint(d, step, st, meta={"t": 0.1 * step})
        else:
            tck.save_checkpoint(d, step, {k: torch.from_numpy(v)
                                          for k, v in st.items()},
                                meta={"t": 0.1 * step})
    step, state, meta = tck.load_checkpoint(d, device="cpu")
    step_j, state_j, meta_j = jck.load_checkpoint(d)
    assert step == step_j == 2 and meta == meta_j == {"step": 2, "t": 0.2}
    for k, v in _state(2).items():
        assert state[k].dtype == torch.from_numpy(v).dtype
        assert np.array_equal(state[k].numpy(), v)
        assert np.array_equal(np.asarray(state_j[k]), v)
    step, state, _ = tck.load_checkpoint(d, step=1, device="cpu")
    assert step == 1 and np.array_equal(state["up_p"].numpy(),
                                        _state(1)["up_p"])


def test_torch_tg_demo_resumes_a_jax_checkpoint(tmp_path, monkeypatch):
    """The port's demo writes the JAX demo's checkpoint files, and resumes
    from a checkpoint the JAX package wrote: two steps at ref 2 in one run
    equal one step, a JAX-written checkpoint of its state, and a resumed
    second step."""
    monkeypatch.chdir(tmp_path)
    argv = ["--ref", "2", "--T", "0.17", "--mesh-root", "synthetic",
            "--pc", "mg", "--pin-pressure", "True", "--device", "cpu",
            "--ckpt", "full", "--ckpt-every", "1"]
    full = tg_demo.main(argv)
    assert full["n_steps"] == 2
    step, state, meta = jck.load_checkpoint("full", step=1)
    assert step == 1
    jck.save_checkpoint("resume", 1, state, meta={"t": meta["t"]})
    resumed = tg_demo.main(argv[:-4] + ["--ckpt", "resume"])
    for k, v in full["norms"].items():
        assert resumed["norms"][k] == v, k
    last = jck.load_checkpoint("full")
    assert last[0] == 2 and np.array_equal(
        np.asarray(last[1]["up_old_f"]), full["up_f"].numpy())


def _spaces(dim, degree, n_fields=1):
    mesh = (rectangle_mesh((0, 0), (1, 1), 3, 3) if dim == 2
            else box_mesh((0, 0, 0), (1, 1, 1), 2, 2, 2))
    st = from_numpy_state(coords=mesh.coords, cells=mesh.cells,
                          material=mesh.material, device="cpu")
    return (FunctionSpace(st.mesh, degree=degree, n_fields=n_fields),
            JSpace(mesh, degree=degree, n_fields=n_fields))


@pytest.mark.parametrize("dim,degree", [(2, 1), (2, 2), (3, 1), (3, 2)])
def test_torch_vtu_same_file(tmp_path, dim, degree):
    """write_vtu: the same bytes as the JAX writer for the same space and
    data (tensors and arrays alike), and read_vtu round-trips them."""
    V, V_j = _spaces(dim, degree)
    rng = np.random.default_rng(dim * 10 + degree)
    u = rng.standard_normal(V.n_nodes)
    vec = rng.standard_normal((V.n_nodes, dim))
    mat = rng.integers(1, 3, V.mesh.n_cells)
    tio.write_vtu(tmp_path / "t.vtu", V,
                  point_data={"u": torch.from_numpy(u), "v": vec},
                  cell_data={"material": torch.from_numpy(mat)})
    jio.write_vtu(tmp_path / "j.vtu", V_j, point_data={"u": u, "v": vec},
                  cell_data={"material": mat})
    assert (tmp_path / "t.vtu").read_bytes() == \
        (tmp_path / "j.vtu").read_bytes()
    out = tio.read_vtu(tmp_path / "t.vtu")
    np.testing.assert_array_equal(out["point_data"]["u"], u)
    np.testing.assert_array_equal(out["cell_data"]["material"], mat)


def test_torch_pvd_series_same_files(tmp_path):
    """PVDSeries: the same .pvd and per-step .vtu files as the JAX series,
    with flat node-interleaved three-field vectors (the Taylor-Green
    demo's layout, velocity and pressure)."""
    V, V_j = _spaces(2, 1, n_fields=3)
    s = tio.PVDSeries(str(tmp_path / "t" / "fields.pvd"))
    s_j = jio.PVDSeries(str(tmp_path / "j" / "fields.pvd"))
    rng = np.random.default_rng(4)
    for k in range(3):
        f = rng.standard_normal(V.n_dofs).reshape(-1, 3)
        pd = {"velocity": f[:, :2], "pressure": f[:, 2]}
        s.write(0.5 * k, V, point_data=pd,
                cell_data={"material": V.mesh.material})
        s_j.write(0.5 * k, V_j, point_data=pd,
                  cell_data={"material": V.mesh.material})
    for name in ("fields.pvd", "fields_000000.vtu", "fields_000002.vtu"):
        assert (tmp_path / "t" / name).read_bytes() == \
            (tmp_path / "j" / name).read_bytes(), name


def test_torch_poisson_demo_writes_vtu(tmp_path):
    """The Poisson demo's --wv on the host: one VTU with the solution, the
    exact field and their difference at every foreground node."""
    path = tmp_path / "poisson.vtu"
    out = poisson_demo.main(["--ref", "1", "--wv", "True", "--ov",
                             str(path), "--device", "cpu"])
    got = tio.read_vtu(path)
    u = got["point_data"]["u"]
    assert u.shape == (got["points"].shape[0],)
    np.testing.assert_allclose(got["point_data"]["error"],
                               u - got["point_data"]["u_exact"], atol=1e-15)
    assert np.isfinite(u).all() and out["norms"]["L2"] > 0
