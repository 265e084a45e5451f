"""The port's VTK writers and the host fields ``simulate`` hands to them
and to the dashboard, against the JAX package's.

The writers must give the same bytes from the same arrays.  ``simulate``'s
outputs are compared on what each package's ``sim`` module passes to
``save_to_vtk`` and ``viz.dashboard`` (patched to capture it), in float64 to
1e-12: the density after the mass correction's rescale, the velocity, the
step and the R^2 history."""

import numpy as np
import pytest

from latticeboltzmannsimulations_torch import sim as t_sim
from latticeboltzmannsimulations_torch.config import SimConfig as TConfig
from latticeboltzmannsimulations_torch.io import vtk as t_vtk
from latticeboltzmannsimulations_tpu import sim as j_sim
from latticeboltzmannsimulations_tpu.config import SimConfig as JConfig
from latticeboltzmannsimulations_tpu.io import vtk as j_vtk

NX, NY = 12, 9


def _fields(dtype):
    rng = np.random.default_rng(3)
    return (rng.standard_normal((2, NX, NY)).astype(dtype),
            (1.0 + 0.01 * rng.standard_normal((NX, NY))).astype(dtype))


def _same_file(writer_name, tmp_path, *args, **kw):
    paths = [getattr(mod, writer_name)(str(tmp_path / name), *args, **kw)
             for mod, name in ((t_vtk, "port"), (j_vtk, "jax"))]
    a, b = (open(p, "rb").read() for p in paths)
    assert a == b
    return a


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_write_vtr_and_vti_give_the_jax_bytes(tmp_path, dtype):
    u, rho = _fields(dtype)
    vel3 = np.concatenate([u, np.zeros_like(u[:1])])
    data = {"velocity": vel3, "pressure": rho, "flag": np.arange(NX * NY, dtype=np.int32)
            .reshape(NX, NY)}
    raw = _same_file("write_vtr", tmp_path, data, spacing=(0.5, 0.25))
    assert raw.startswith(b'<?xml version="1.0"?>') and f'WholeExtent="0 {NX} 0 {NY} 0 0"'.encode() in raw
    _same_file("write_vti", tmp_path, data, spacing=(0.5, 0.25), origin=(1.0, 2.0))


def test_write_vtp_points_gives_the_jax_bytes(tmp_path):
    rng = np.random.default_rng(4)
    x, y = rng.random(5), rng.random(5)
    _same_file("write_vtp_points", tmp_path, x, y,
               {"strength": rng.random(5), "id": np.arange(5, dtype=np.int64)})
    _same_file("write_vtp_points", tmp_path, x, y, {"z": rng.random(5).astype(np.float32)},
               z=rng.random(5))


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_save_to_vtk_gives_the_jax_bytes_bottom_up(tmp_path, dtype):
    u, rho = _fields(dtype)
    a = t_vtk.save_to_vtk(u, rho, "ldc", 3, out_dir=str(tmp_path / "port"))
    b = j_vtk.save_to_vtk(u, rho, "ldc", 3, out_dir=str(tmp_path / "jax"))
    assert a.endswith("ldc.3.vtr") and open(a, "rb").read() == open(b, "rb").read()
    # the last array of the appended block is the pressure, y flipped to bottom-up
    raw = open(a, "rb").read()
    tail = raw[:raw.rindex(b"\n  </AppendedData>")][-4 * NX * NY:]
    got = np.frombuffer(tail, np.float32).reshape(NY, NX).T
    np.testing.assert_array_equal(got, rho[:, ::-1].astype(np.float32))


def _capture(monkeypatch, module):
    """Patch ``module``'s ``save_to_vtk`` and ``viz.dashboard`` to record
    what ``simulate`` passes them."""
    vtk, dash = [], []
    monkeypatch.setattr(module, "save_to_vtk", lambda u, rho, prefix, n, out_dir: vtk.append(
        (np.array(u), np.array(rho), n)))
    monkeypatch.setattr(module.viz, "dashboard", lambda cfg, rho, u, step, hist, **kw: dash.append(
        (np.array(u), np.array(rho), step, list(hist))))
    return vtk, dash


@pytest.mark.parametrize("mass_correction", [True, False])
def test_simulate_hands_the_jax_host_fields_to_vtk_and_dashboard(tmp_path, monkeypatch,
                                                                 mass_correction):
    """48^2 MRT Re=100 in float64: the density drifts by about 1e-4 per
    interval here, so without the rescale after the mass correction the
    captured density's mean would miss 1 by far more than 1e-9."""
    kw = dict(nx=48, ny=48, reynolds=100.0, collision="mrt", precision="float64",
              max_steps=300, report_interval=100)
    captured = {}
    for name, module, cfg, extra in (
            ("port", t_sim, TConfig(**kw), dict(device="cpu")),
            ("jax", j_sim, JConfig(**kw), {})):
        vtk, dash = _capture(monkeypatch, module)
        opts = module.SimOptions(out_dir=str(tmp_path / name), verbose=False,
                                 metrics_jsonl=False, save_plots=True, save_vtk=True,
                                 mass_correction=mass_correction,
                                 **({} if name == "port" else {"backend": "jit"}))
        module.simulate(cfg, opts, **extra)
        captured[name] = (vtk, dash)
    (t_vtk_calls, t_dash), (j_vtk_calls, j_dash) = captured["port"], captured["jax"]
    assert [n for *_, n in t_vtk_calls] == [n for *_, n in j_vtk_calls] == [0, 1, 2]
    assert [s for _, _, s, _ in t_dash] == [s for _, _, s, _ in j_dash] == [100, 200, 300]
    for (tu, trho, _), (ju, jrho, _) in zip(t_vtk_calls, j_vtk_calls):
        np.testing.assert_allclose(tu, ju, rtol=0, atol=1e-12)
        np.testing.assert_allclose(trho, jrho, rtol=0, atol=1e-12)
        if mass_correction:
            assert abs(trho.mean() - 1.0) < 1e-12 and abs(jrho.mean() - 1.0) < 1e-12
        else:
            assert abs(trho.mean() - 1.0) > 1e-9
    for (tu, trho, _, th), (ju, jrho, _, jh), (vu, vrho, _) in zip(t_dash, j_dash, t_vtk_calls):
        np.testing.assert_array_equal(tu, vu)
        np.testing.assert_array_equal(trho, vrho)
        np.testing.assert_allclose(tu, ju, rtol=0, atol=1e-12)
        np.testing.assert_allclose(trho, jrho, rtol=0, atol=1e-12)
        assert [s for s, _ in th] == [s for s, _ in jh]
        np.testing.assert_allclose([r for _, r in th], [r for _, r in jh], rtol=0, atol=1e-12)
    assert len(t_dash[-1][3]) == 3
