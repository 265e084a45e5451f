"""The port's Reynolds-sweep path against the JAX package's on the CPU: the
plain stacked step (the sweep kernel's plain version) against JAX's
interpret-mode ``make_sweep_runner`` and its traced-omega engine step, and
``ml.generate_dataset`` against JAX's on the same sweep.

Tolerances: float64 to 1e-12 (the same algorithm in another framework);
float32 to atol 2e-5 over a few steps (another float32 implementation of
the step: FMA contraction and the order of operations differ); the
dataset files byte for byte (the same NumPy on the same arrays)."""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from latticeboltzmannsimulations_torch import engine
from latticeboltzmannsimulations_torch.config import SimConfig
from latticeboltzmannsimulations_torch.kernels import pull
from latticeboltzmannsimulations_torch.ml import datagen
from latticeboltzmannsimulations_torch.parallel.mesh import Mesh, make_mesh
from latticeboltzmannsimulations_tpu import engine as jengine
from latticeboltzmannsimulations_tpu.config import SimConfig as JConfig
from latticeboltzmannsimulations_tpu.kernels import pallas_pull
from latticeboltzmannsimulations_tpu.ml import datagen as jdatagen

ATOL = 2e-5
CPU = torch.device("cpu")
SWEEP_RE = (150.0, 900.0, 2500.0)
DATASET_RE = np.array([100.0, 150.0, 200.0])
DATASET_CFG = dict(nx=32, ny=32, reynolds=100.0, collision="srt", max_steps=300,
                   report_interval=100, convergence_tol=1e-5, convergence_hits=2)


def _both(**kw):
    return SimConfig(**kw), JConfig(**kw)


def _np(t):
    return np.asarray(t)


# --- the stacked step ---------------------------------------------------------

@pytest.fixture(scope="module")
def sweep_case():
    """64^2 SRT + Smagorinsky, three cavities stacked from rest, 8 steps
    through the port's plain stacked step and through JAX's interpret-mode
    sweep runner (as tests/test_pallas.py runs it)."""
    cfg, jcfg = _both(nx=64, ny=64, reynolds=400.0, collision="srt",
                      turbulence="smagorinsky")
    n_cav, n = 3, 8
    omegas = np.array([dataclasses.replace(cfg, reynolds=r).omega for r in SWEEP_RE],
                      np.float32)
    s0 = engine.init_state(cfg, "cpu")
    stacked = engine.stack_cavities(engine.State(
        s0.f.expand(n_cav, *s0.f.shape), s0.rho_lid.expand(n_cav, *s0.rho_lid.shape)))
    step = engine.make_stacked_step_omega(cfg, n_cav)
    out = stacked
    for _ in range(n):
        out = step(out, torch.from_numpy(omegas))
    j0 = jengine.init_state(jcfg)
    jstacked = jengine.State(f=jnp.concatenate([j0.f] * n_cav, axis=1),
                             rho_lid=jnp.concatenate([j0.rho_lid] * n_cav))
    jout = pallas_pull.make_sweep_runner(jcfg, n_cav, n, interpret=True)(
        jstacked, jnp.asarray(omegas))
    return cfg, jcfg, omegas, n, out, jout


def test_stacked_step_matches_jax_sweep_runner(sweep_case):
    cfg, _, _, _, out, jout = sweep_case
    np.testing.assert_allclose(out.f.numpy(), _np(jout.f), rtol=0, atol=ATOL)
    np.testing.assert_allclose(out.rho_lid.numpy(), _np(jout.rho_lid), rtol=0, atol=ATOL)
    assert out.f.shape == (9, 3 * cfg.nx, cfg.ny)


def test_stacked_step_matches_jax_traced_omega_steps(sweep_case):
    """Each cavity of the stack against its own run of JAX's
    ``engine.make_fused_step_omega``."""
    cfg, jcfg, omegas, n, out, _ = sweep_case
    jstep = jax.jit(jengine.make_fused_step_omega(jcfg))
    for c, om in enumerate(omegas):
        s = jengine.init_state(jcfg)
        for _ in range(n):
            s = jstep(s, jnp.float32(om))
        cols = slice(c * cfg.nx, (c + 1) * cfg.nx)
        np.testing.assert_allclose(out.f[:, cols].numpy(), _np(s.f), rtol=0, atol=ATOL)
        np.testing.assert_allclose(out.rho_lid[cols].numpy(), _np(s.rho_lid),
                                   rtol=0, atol=ATOL)


def test_sweep_runner_on_cpu_is_the_plain_stacked_step(sweep_case):
    """``pull.make_sweep_runner`` on CPU tensors runs the plain version, and
    each cavity of it equals ``make_scan_runner_omega`` alone, bit for bit."""
    cfg, _, omegas, n, out, _ = sweep_case
    s0 = engine.init_state(cfg, "cpu")
    stacked = engine.stack_cavities(engine.State(
        s0.f.expand(3, *s0.f.shape), s0.rho_lid.expand(3, *s0.rho_lid.shape)))
    got = pull.make_sweep_runner(cfg, 3, n, "cpu")(stacked, omegas)
    assert torch.equal(got.f, out.f) and torch.equal(got.rho_lid, out.rho_lid)
    single = pull.make_scan_runner_omega(cfg, n, "cpu")
    for c, om in enumerate(omegas):
        one = single(s0, float(om))
        cols = slice(c * cfg.nx, (c + 1) * cfg.nx)
        assert torch.equal(one.f, got.f[:, cols])
        assert torch.equal(one.rho_lid, got.rho_lid[cols])


def test_cavity_table_is_jax_traced_omega_arithmetic():
    """The kernel's per-cavity scalars: float32 arithmetic on the float32
    omega, as the JAX traced-omega step computes tau0 and omega^-."""
    cfg = SimConfig(collision="trt")
    om = jnp.asarray([1.9, 1.2345678, 0.7], jnp.float32)
    tau0 = 1.0 / om
    want = np.stack([_np(om), _np(tau0), _np(tau0 * tau0),
                     _np(1.0 / (0.5 + cfg.trt_magic / (tau0 - 0.5)))], axis=1)
    got = pull.cavity_table(cfg, [1.9, 1.2345678, 0.7])
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kw, traced, n_cav, words", [
    (dict(turbulence="smagorinsky", van_driest=True), True, 1, "Van Driest"),
    (dict(), False, 2, "traced omega"),
    (dict(), True, pull.MAX_CAVITIES + 1, "cavities"),
    (dict(nx=2**16), True, 2**15, "columns"),
    (dict(precision="float64"), True, 2, "float32"),
])
def test_sweep_form_refuses_what_it_cannot_run(kw, traced, n_cav, words):
    cfg = SimConfig(**kw)
    assert words in pull.unsupported_reason(cfg, traced, n_cav)
    with pytest.raises(ValueError, match=words):
        pull.make_sweep_runner(cfg, n_cav, 1, "cpu") if traced else pull._check_cfg(
            cfg, traced, n_cav)


# --- generate_dataset ---------------------------------------------------------

def _generate_both(precision, re_values=DATASET_RE, batch_size=3):
    cfg, jcfg = _both(**DATASET_CFG, precision=precision)
    flags, jflags = [], []
    ds = datagen.generate_dataset(
        cfg, re_values=re_values, batch_size=batch_size, device="cpu",
        on_batch=lambda *a: flags.append((a[0].tolist(), a[3], a[4].tolist(), a[5].tolist())))
    jds = jdatagen.generate_dataset(
        jcfg, re_values=re_values, batch_size=batch_size,
        on_batch=lambda *a: jflags.append((a[0].tolist(), a[3], np.asarray(a[4]).tolist(),
                                           np.asarray(a[5]).tolist())))
    return ds, jds, flags, jflags


def test_generate_dataset_matches_jax_in_float64():
    """The whole dataset, through the plain batched engine here and JAX's
    vmapped engine there, in float64: fields to 1e-12, the quarantine mask
    and the per-batch callback's flags equal."""
    ds, jds, flags, jflags = _generate_both("float64", batch_size=2)
    assert ds.f_final.dtype == np.float64
    np.testing.assert_array_equal(ds.re_range, jds.re_range)
    np.testing.assert_allclose(ds.feq_initial, jds.feq_initial, rtol=0, atol=1e-12)
    np.testing.assert_allclose(ds.f_final, jds.f_final, rtol=0, atol=1e-12)
    np.testing.assert_allclose(ds.u_final, jds.u_final, rtol=0, atol=1e-12)
    np.testing.assert_array_equal(ds.failed, jds.failed)
    assert flags == jflags and len(flags) == 2


def test_generate_dataset_quarantines_a_diverging_cavity():
    """A diverging Re (negative: omega > 2) in a batch is marked failed with
    zeroed fields; the rest of the batch completes, as in the JAX package."""
    cfg = SimConfig(**{**DATASET_CFG, "max_steps": 400})
    ds = datagen.generate_dataset(cfg, re_values=np.array([100.0, -50.0, 200.0]),
                                  batch_size=3, device="cpu")
    assert ds.failed.tolist() == [False, True, False]
    assert np.all(ds.f_final[1] == 0.0) and np.all(ds.u_final[1] == 0.0)
    for i in (0, 2):
        assert np.all(np.isfinite(ds.f_final[i]))
        assert np.abs(ds.u_final[i]).max() > 0.0


def test_stacked_and_sequential_routes_on_cpu_match_the_batched_route():
    """The card's two routes, driven on the CPU (their runners then run the
    plain stacked step): the stack, with a short last batch padded by
    repeats and a diverging cavity beside a stable one, equals the plain
    batched route bit for bit; the one-at-a-time route, whose mass scale is
    reduced on the host, to float32 rounding."""
    cfg = SimConfig(**DATASET_CFG)
    res = np.array([100.0, -50.0, 200.0])
    want = datagen.generate_dataset(cfg, re_values=res, batch_size=2, device="cpu")
    calls = []
    stacked = datagen._generate_batches(cfg, res, 2, None,
                                        lambda *a: calls.append(a[0].tolist()),
                                        [torch.device("cpu")], stacked=True)
    assert calls == [[100.0, -50.0], [200.0]]
    for name in ("f_final", "u_final", "failed"):
        np.testing.assert_array_equal(getattr(stacked, name), getattr(want, name))
    seq = datagen._generate_sequential(cfg, res, None, None, torch.device("cpu"))
    np.testing.assert_array_equal(seq.failed, want.failed)
    np.testing.assert_allclose(seq.f_final, want.f_final, rtol=0, atol=ATOL)
    np.testing.assert_allclose(seq.u_final, want.u_final, rtol=0, atol=ATOL)


def test_generate_dataset_routes_the_card_and_refuses_a_mesh():
    """The card's route needs a CUDA device; a mesh that spans the processes
    of a group is refused."""
    cfg = SimConfig(**DATASET_CFG)
    assert datagen.sweep_kernel_reason(cfg, "cpu") == "not on a CUDA device"
    cpu = torch.device("cpu")
    spanning = Mesh((2, 1), ((cpu,), (cpu,)), ranks=((0,), (1,)), rank=0)
    assert spanning.spans_processes
    with pytest.raises(NotImplementedError, match="ROADMAP.md queue 1"):
        datagen.generate_dataset(cfg, re_values=DATASET_RE, mesh=spanning)


def test_generate_dataset_refuses_a_mesh_that_mixes_device_types():
    """One route serves every part, so a mesh of the CPU and a card is
    refused before anything runs (the card's part would take the plain
    engine)."""
    cfg = SimConfig(**DATASET_CFG)
    with pytest.raises(ValueError, match="mixes device types"):
        datagen.generate_dataset(cfg, re_values=DATASET_RE,
                                 mesh=make_mesh((2, 1), ["cpu", "cuda:0"]))


MESH_RE = np.array([100.0, 150.0, 200.0, 250.0, 300.0])  # batches of 2, 2 and 1


def test_generate_dataset_on_a_mesh_matches_jax_mesh_and_no_mesh():
    """A (2, 1) mesh of the CPU, in float64: each batch of 2 split into one
    cavity per entry, the last batch of 1 (which does not divide) on the
    first; against ``mesh=None`` bit for bit and against JAX's mesh path
    over two of its virtual CPU devices to 1e-12, the callback's flags
    equal."""
    cfg, jcfg = _both(**DATASET_CFG, precision="float64")
    flags, jflags, plain_flags = [], [], []

    def record(out):
        return lambda *a: out.append((a[0].tolist(), a[3], np.asarray(a[4]).tolist(),
                                      np.asarray(a[5]).tolist()))

    ds = datagen.generate_dataset(cfg, re_values=MESH_RE, batch_size=2, on_batch=record(flags),
                                  mesh=make_mesh((2, 1), ["cpu"] * 2))
    plain = datagen.generate_dataset(cfg, re_values=MESH_RE, batch_size=2,
                                     on_batch=record(plain_flags), device="cpu")
    jmesh = jax.sharding.Mesh(np.asarray(jax.devices()[:2]), ("batch",))
    jds = jdatagen.generate_dataset(jcfg, re_values=MESH_RE, batch_size=2,
                                    on_batch=record(jflags), mesh=jmesh)
    for name in ("f_final", "u_final", "failed", "feq_initial"):
        np.testing.assert_array_equal(getattr(ds, name), getattr(plain, name))
    for name in ("f_final", "u_final", "feq_initial"):
        np.testing.assert_allclose(getattr(ds, name), getattr(jds, name), rtol=0, atol=1e-12)
    np.testing.assert_array_equal(ds.failed, jds.failed)
    assert flags == plain_flags == jflags and len(flags) == 3


def test_stacked_route_over_a_mesh_equals_one_stack():
    """The card's route with two entries, driven on the CPU (each part a
    stack through the sweep runner's plain stacked step), a diverging
    cavity in one part: equal to the single stack bit for bit; the parts
    of a divided batch go to their entries, an indivisible batch to the
    first."""
    cfg = SimConfig(**DATASET_CFG)
    res = np.array([100.0, -50.0, 200.0, 250.0, 300.0])
    one = datagen._generate_batches(cfg, res, 2, None, None, [CPU], stacked=True)
    two = datagen._generate_batches(cfg, res, 2, None, None, [CPU, CPU], stacked=True)
    for name in ("f_final", "u_final", "failed"):
        np.testing.assert_array_equal(getattr(two, name), getattr(one, name))
    assert two.failed.tolist() == [False, True, False, False, False]
    assert datagen._parts(4, 2) == [(0, 2, 0), (2, 4, 1)]
    assert datagen._parts(3, 2) == [(0, 3, 0)]
    assert datagen._parts(3, 1) == [(0, 3, 0)]


# --- the dataset files ----------------------------------------------------------

def _random_dataset(module, failed):
    rng = np.random.default_rng(3)
    n = len(failed)
    return module.DatasetArrays(
        re_range=np.linspace(100.0, 500.0, n),
        feq_initial=rng.standard_normal((9, 8, 6)).astype(np.float32),
        f_final=rng.standard_normal((n, 9, 8, 6)).astype(np.float32),
        u_final=rng.standard_normal((n, 2, 8, 6)).astype(np.float32),
        failed=failed)


@pytest.mark.parametrize("failed", [np.array([False, True, False, True, False]),
                                    np.zeros(5, bool)], ids=["failed", "clean"])
def test_dataset_files_and_filters_are_byte_equal_to_jax(tmp_path, failed):
    """``save_dataset``/``load_dataset``, ``drop_failed`` and
    ``bit_reversed_batches`` on the same float32 arrays: the same files,
    byte for byte, and the same arrays."""
    ds, jds = _random_dataset(datagen, failed), _random_dataset(jdatagen, failed)
    datagen.save_dataset(ds, str(tmp_path / "port"))
    jdatagen.save_dataset(jds, str(tmp_path / "jax"))
    names = sorted(os.listdir(tmp_path / "jax"))
    assert sorted(os.listdir(tmp_path / "port")) == names
    assert ("failed.npy" in names) == bool(failed.any())
    for name in names:
        assert (tmp_path / "port" / name).read_bytes() == (tmp_path / "jax" / name).read_bytes()
    kept = datagen.drop_failed(datagen.load_dataset(str(tmp_path / "jax")))
    jkept = jdatagen.drop_failed(jdatagen.load_dataset(str(tmp_path / "port")))
    for field in ("re_range", "feq_initial", "f_final", "u_final", "failed"):
        a, b = getattr(kept, field), getattr(jkept, field)
        assert (a is None) == (b is None)
        if a is not None:
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    values = np.arange(100.0, 5100.0, 10.0)
    for batch in (1, 7, 32, 500):
        assert datagen.bit_reversed_batches(values, batch).tobytes() == \
            jdatagen.bit_reversed_batches(values, batch).tobytes()
