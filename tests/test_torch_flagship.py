"""The flagship, bart_tpu's 4-molecule WASP-12b eclipse retrieval, through
bart_tpu_torch on the CPU against bart_tpu.

(a) both packages' ``Pipeline`` on the twins of examples/wasp12b_eclipse
    .cfg and wasp12b_eclipse_fold.cfg in examples/torch_demo at a tiny
    size (16 layers, 25 cm-1 bins, 650 K T-nodes, the 600 strongest lines
    of each of the four species), each package in its own directory: the
    host files byte for byte, the atm file at 1e-10, the 4-species
    opacity table (each package's own float32 build) at 1e-9, the bands
    at the truth on one shared table at 1e-9 in float64, K = 1 and folded
    (rtosamp 4), and the forward's rows: 4 x nT + the CIA table's nT;
(b) make_inputs.py's pin (the table at each layer's two T-nodes around
    the truth's profile) against the pipeline's whole table;
(c) examples/torch_demo/run_wasp12b.py run on the CPU at the tiny size
    for a few blocks: its timing JSON holds exactly the keys of the
    original's (bart_tpu's examples/run_wasp12b.py, read by ``ast``);
(d) the plain versions past the kernels' old ceilings (226 rows, 130
    layers) against bart_tpu's ``_single``, ``_single_folded``,
    ``_tsingle`` and ``_tsingle_folded`` under vmap at float64.

The emulations of the tensor-core arithmetic at those sizes are in
tests/test_torch_k1_mma.py and tests/test_torch_split.py.
"""

import ast
import importlib.util
import json
import shutil
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch

from bart_tpu.driver import config as jconfig
from bart_tpu.driver.pipeline import Pipeline as JPipeline

import bart_tpu_torch.rt.fused as fused
from bart_tpu_torch.demo import random_rows, random_transit_rows
from bart_tpu_torch.driver import config
from bart_tpu_torch.driver.pipeline import Pipeline
from bart_tpu_torch.io.atm import read_atm
from bart_tpu_torch.linelist.tli import TliData, load_tli, save_tli
from bart_tpu_torch.opacity.cia import read_cia
from bart_tpu_torch.opacity.grid import load_grid
from bart_tpu_torch.rt.eclipse import expsum_weights, raygrid_weights

REPO = Path(__file__).resolve().parents[1]
DEMO = REPO / "examples" / "torch_demo"
TINY = {"n_layers": "16", "tempdelt": "650", "wndelt": "25",
        "quiet": "True"}
NLINES = 600
RTOL = 1e-9
SPECIES = ("H2O", "CO2", "CO", "CH4")
#: (cfg, overrides): K = 1 and folded at rtosamp = 4
CASES = {"k1": ("wasp12b_eclipse", {}),
         "fold": ("wasp12b_eclipse_fold", {"rtosamp": "4"})}
OPACITY = {"k1": "opacity_4mol.npz", "fold": "opacity_4mol_fold32.npz"}
F64 = torch.float64


@pytest.fixture(autouse=True)
def _cap_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


@pytest.fixture(scope="module")
def work(tmp_path_factory):
    """A work directory holding the tiny 4-molecule line list."""
    root = tmp_path_factory.mktemp("flagship")
    src = load_tli(str(REPO / "examples" / "demo_inputs"
                       / "wasp12b_4mol.tli.npz"))
    lines = {s: src.lines[s].strongest(NLINES) for s in SPECIES}
    save_tli(TliData(list(SPECIES), lines, src.wn_min, src.wn_max),
             str(root / "lines.tli.npz"))
    return root


def cfgs(work, case, loc, **over):
    """(the port's cfg, bart_tpu's cfg) of a flagship twin at the tiny
    size, with loc_dir ``loc``."""
    name, case_over = CASES[case]
    ov = {**TINY, "loc_dir": str(loc),
          "linedb": str(work / "lines.tli.npz"), **case_over, **over}
    path = str(DEMO / f"{name}.cfg")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return config.load_config(path, ov), jconfig.load_config(path, ov)


def _stages(pipe, jax: bool):
    """The stages up to the opacity table, as run_wasp12b.py runs them:
    (atm, wn, grid)."""
    cfg = pipe.cfg
    pressure = pipe.stage_pressure()
    atm = pipe.stage_atmosphere(pressure, pipe.stage_abundances())
    wn = cfg.wavenumber_grid()
    if cfg.fold_K > 1:
        from bart_tpu_torch.utils.grids import folded_fine_grid

        wn_rt = folded_fine_grid(wn, cfg.fold_K)
    else:
        wn_rt = wn
    grid = pipe.stage_opacity(pipe.stage_linelist(wn_rt), wn_rt, pressure,
                              atm)
    return atm, wn, grid


@pytest.fixture(scope="module")
def jax_runs(work):
    """bart_tpu's stages and forward on each case, in its own directory:
    {case: (directory, atm, bands at the truth)}."""
    import jax.numpy as jnp

    out = {}
    for case in CASES:
        loc = work / f"jax_{case}"
        _, jcfg = cfgs(work, case, loc)
        jp = JPipeline(jcfg)
        atm, wn, grid = _stages(jp, True)
        fm = jp._build_forward(atm, wn, grid)
        truth = jnp.asarray(np.asarray(jcfg.params, np.float64))
        bands, _, ok = fm.jitted()(truth)
        assert bool(ok)
        out[case] = (loc, atm, np.asarray(bands))
    return out


def test_host_stages_equal(work, jax_runs):
    """The pressure and abundance files byte for byte, the atm file's T,
    q and radii at 1e-10 (the twin's ten species, uniform)."""
    jloc = jax_runs["k1"][0]
    loc = work / "port_host"
    cfg, _ = cfgs(work, "k1", loc)
    pipe = Pipeline(cfg, device="cpu", dtype=F64)
    atm = pipe.stage_atmosphere(pipe.stage_pressure(),
                                pipe.stage_abundances())
    for f in ("atm.pres", "abundances.abn"):
        assert (loc / f).read_bytes() == (jloc / f).read_bytes(), f
    got, ref = read_atm(str(loc / "atmosphere.atm")), \
        read_atm(str(jloc / "atmosphere.atm"))
    assert got.species == ref.species == atm.species
    assert len(atm.species) == 10
    for field in ("pressure", "temperature", "abundances", "radius"):
        np.testing.assert_allclose(getattr(got, field), getattr(ref, field),
                                   rtol=1e-10, atol=0, err_msg=field)


@pytest.mark.parametrize("case", list(CASES))
def test_opacity_table_of_four_species(work, jax_runs, case):
    """Each package's own build of the 4-species table (float32 both) at
    1e-9: the K = 1 table and the rtosamp = 4 fine one."""
    jloc = jax_runs[case][0]
    loc = work / f"port_opacity_{case}"
    cfg, _ = cfgs(work, case, loc)
    _, wn, grid = _stages(Pipeline(cfg, device="cpu", dtype=F64), False)
    ref = load_grid(str(jloc / OPACITY[case]), device="cpu")
    got, want = grid.sigma.numpy(), ref.sigma.numpy()
    K = 4 if case == "fold" else 1
    assert got.dtype == want.dtype == np.float32
    assert got.shape == want.shape == (4, 5, 16, len(wn) * K)
    assert grid.species == ref.species == list(SPECIES)
    assert float(want.max()) > 0.0
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=0)


@pytest.mark.parametrize("case", list(CASES))
def test_bands_at_the_truth_and_the_rows(work, jax_runs, case):
    """The port's forward on bart_tpu's table (copied into its own
    directory) at the cfg's truth: the bands at 1e-9 in float64; its
    kernel rows are 4 molecules x nT + the CIA table's T-nodes."""
    jloc, _, jbands = jax_runs[case]
    loc = work / f"port_bands_{case}"
    loc.mkdir()
    shutil.copy(jloc / OPACITY[case], loc / OPACITY[case])
    cfg, _ = cfgs(work, case, loc)
    pipe = Pipeline(cfg, device="cpu", dtype=F64)
    atm, wn, grid = _stages(pipe, False)
    fm = pipe._build_forward(atm, wn, grid)
    bands, _, valid = fm(torch.tensor(np.asarray(cfg.params)[None]))
    assert bool(valid[0]) and bands.shape == (1, 4)
    np.testing.assert_allclose(bands[0].numpy(), jbands, rtol=RTOL)
    assert np.all((jbands > 1e-3) & (jbands < 1e-2))    # eclipse depths
    n_cia = len(read_cia(cfg.csfile[0]).temps)
    parts, _ = fm._fused_rows(torch.tensor(np.asarray(cfg.params)[None]),
                              fm.tables, *fm._profiles(
                                  torch.tensor(np.asarray(cfg.params)[None]),
                                  fm.tables)[:3])
    rows = {int(p[0].tab.shape[0]) for p in parts}
    assert rows == {4 * len(grid.t_grid) + n_cia} == {4 * 5 + 14}


def _make_inputs():
    spec = importlib.util.spec_from_file_location(
        "make_inputs", DEMO / "make_inputs.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_pin_on_bracketing_nodes_equals_the_whole_table(work, jax_runs,
                                                        tmp_path):
    """make_inputs.py's pin builds each layer's two T-nodes around the
    truth's profile only: its bands equal the whole table's bit for bit
    in float64 (the K = 1 forward on the port's own table)."""
    mi = _make_inputs()
    tiny = {"n_layers": "8", "tempdelt": "200"}     # three brackets
    over = {**TINY, "linedb": str(work / "lines.tli.npz"), **tiny}
    got = mi.pinned_bands(str(DEMO / "wasp12b_eclipse.cfg"),
                          mi.WASP12B_TRUTH, str(tmp_path / "pin"), "cpu",
                          F64, over)
    cfg, _ = cfgs(work, "k1", tmp_path / "whole", **tiny)
    pipe = Pipeline(cfg, device="cpu", dtype=F64)
    atm, wn, grid = _stages(pipe, False)
    fm = pipe._build_forward(atm, wn, grid)
    want = fm(torch.tensor(mi.WASP12B_TRUTH[None]))[0][0].numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(mi.WASP12B_TRUTH, cfg.params)


def test_irac_stand_ins_are_top_hats_inside_the_grid():
    """filters/firac{1..4}.dat: top-hats over the IRAC channels'
    half-response bands, inside the twins' 910-3400 cm-1, read alike by
    both packages."""
    from bart_tpu.io.filters import read_filter as jread_filter

    from bart_tpu_torch.io.filters import read_filter

    mi = _make_inputs()
    for k, (lo, hi) in enumerate(mi.IRAC_BANDS, start=1):
        path = str(DEMO / "filters" / f"firac{k}.dat")
        wn, resp = read_filter(path)
        jwn, jresp = jread_filter(path)
        np.testing.assert_array_equal(wn, jwn)
        np.testing.assert_array_equal(resp, jresp)
        np.testing.assert_array_equal(resp, 1.0)
        np.testing.assert_allclose([wn[0], wn[-1]], [1e4 / hi, 1e4 / lo],
                                   rtol=1e-12)
        assert 910.0 < wn[0] < wn[-1] < 3400.0
        assert "stand-in" in (DEMO / "filters" / f"firac{k}.dat").read_text()


def _original_timing_keys() -> set:
    """The keys of the timing dict of bart_tpu's examples/run_wasp12b.py,
    read from its source."""
    tree = ast.parse((REPO / "examples" / "run_wasp12b.py").read_text())
    for node in ast.walk(tree):
        if (isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict)
                and any(getattr(t, "id", None) == "timing"
                        for t in node.targets)):
            return {k.value for k in node.value.keys}
    raise AssertionError("no timing dict in examples/run_wasp12b.py")


def test_runner_writes_the_originals_timing_keys(work, tmp_path,
                                                 monkeypatch, capsys):
    """run_wasp12b.py --short on the CPU at the tiny size, 3 blocks of
    100 steps: its checks run, and its JSON holds exactly the original's
    keys with values of the same kinds."""
    spec = importlib.util.spec_from_file_location(
        "run_wasp12b", DEMO / "run_wasp12b.py")
    runner = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(runner)
    load = runner.load_config

    def tiny(path, over):
        return load(path, {**over, **TINY,
                           "linedb": str(work / "lines.tli.npz"),
                           "numit": "4800", "burnin": "100"})

    monkeypatch.setattr(runner, "load_config", tiny)
    out = tmp_path / "short"
    rc, state = runner.run(["--short", "--device", "cpu", "--outdir",
                            str(out)])
    assert rc in (0, 1)              # 300 steps need not converge
    timing = json.loads((out / "wasp12b_timing.json").read_text())
    assert set(timing) == _original_timing_keys()
    assert timing["mode"] == "short" and timing["backend"] == "cpu"
    assert timing["nchains"] == 16 and timing["numit"] == 4800
    assert timing["passed"] == (rc == 0) == (not state["failures"])
    assert set(timing["split_rhat"]) == {"kappa", "g1", "beta", "H2O",
                                         "CO2", "CO", "CH4"}
    assert np.isfinite(timing["chi2_best"]) and timing["mcmc_s"] > 0
    assert state["result"].posterior.shape[:2] == (16, 7)
    # a usage error (argparse's exit 2), which holds under python -O too
    with pytest.raises(SystemExit) as exc:
        runner.run(["--short", "--fold", "--device", "cpu"])
    assert exc.value.code == 2
    assert "--fold and --short are exclusive" in capsys.readouterr().err


# ---------------------------------------------------------------------
# (d) the plain versions past the kernels' old ceilings

@pytest.fixture
def jx():
    import jax
    import jax.numpy as jnp

    import bart_tpu.rt.fused as jfused

    return jax, jnp, jfused


def _t(a):
    return torch.tensor(np.asarray(a), dtype=F64)


MANY_R, MANY_L, K = 226, 130, 4


@pytest.mark.parametrize("quad", ["raygrid", "expsum"])
def test_eclipse_plain_versions_at_226_rows(jx, quad):
    jax, jnp, jfused = jx
    (mu, muw), powers = {"raygrid": (raygrid_weights(
        [0.0, 20.0, 40.0, 60.0, 80.0]), False),
        "expsum": (expsum_weights(8), True)}[quad]
    tab, wn, wrows, T, drp = random_rows(MANY_R, 23, 12, 3)
    wrows = wrows * 27.0 / MANY_R
    args = [wn, mu, muw]
    ref = jax.vmap(lambda w, t, d: jfused._single(
        jnp.asarray(tab), *[jnp.asarray(a) for a in args], w, t, d,
        powers=powers))(*[jnp.asarray(a) for a in (wrows, T, drp)])
    got = fused.eclipse_plain(_t(tab), *[_t(a) for a in args], _t(wrows),
                              _t(T), _t(drp), powers=powers)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-10)
    # folded: K sub-samples of structure per bin
    rng = np.random.default_rng(2)
    fine = (tab[..., None] * rng.lognormal(0.0, 0.5, tab.shape + (K,))
            ).reshape(MANY_R, 23, 12 * K)
    tabk = jfused.fold_table(jnp.asarray(fine), K)
    ref = jax.vmap(lambda w, t, d: jfused._single_folded(
        tabk, *[jnp.asarray(a) for a in args], w, t, d,
        powers=powers))(*[jnp.asarray(a) for a in (wrows, T, drp)])
    got = fused.eclipse_folded_plain(
        fused.folded_table(_t(fine), K), *[_t(a) for a in args], _t(wrows),
        _t(T), _t(drp), powers=powers)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-10)


def test_transit_plain_versions_at_130_layers(jx):
    jax, jnp, jfused = jx
    tab, wrows, G, wgt, _ = random_transit_rows(7, MANY_L, 12, 3)
    ref = jax.vmap(jfused._tsingle, in_axes=(None, 0, 0, 0))(
        *[jnp.asarray(a) for a in (tab, wrows, G, wgt)])
    got = fused.transit_plain(*[_t(a) for a in (tab, wrows, G, wgt)])
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-9)
    tau = torch.bmm(_t(G), torch.einsum("clr,rlw->clw", _t(wrows), _t(tab)))
    assert float(((tau > 0.1) & (tau < 10.0)).double().mean()) > 0.2
    rng = np.random.default_rng(4)
    fine = (tab[..., None] * rng.lognormal(0.0, 0.5, tab.shape + (K,))
            ).reshape(7, MANY_L, 12 * K)
    ref = jax.vmap(jfused._tsingle_folded, in_axes=(None, 0, 0, 0))(
        jfused.fold_table(jnp.asarray(fine), K),
        *[jnp.asarray(a) for a in (wrows, G, wgt)])
    got = fused.transit_folded_plain(fused.folded_table(_t(fine), K),
                                     *[_t(a) for a in (wrows, G, wgt)])
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-9)


def test_wrappers_take_many_rows_and_layers_on_the_cpu():
    """On CPU tensors the wrappers run the plain versions at any row and
    layer count (the card's kernels take them too: chip_smoke.py phase
    2b, and the gpu cases of the kernel tests)."""
    (mu, muw), _ = (raygrid_weights([0.0, 20.0, 40.0, 60.0, 80.0]), False)
    tab, wn, wrows, T, drp = (_t(a) for a in random_rows(300, 5, 8, 2))
    got = fused.fused_eclipse(fused.rows_table(tab), wn, _t(mu), _t(muw),
                              wrows, T, drp)
    np.testing.assert_array_equal(
        got.numpy(), fused.eclipse_plain(tab, wn, _t(mu), _t(muw), wrows,
                                         T, drp).numpy())
    tab, wrows, G, wgt = (_t(a) for a in random_transit_rows(3, 400, 8, 2)[:4])
    got = fused.fused_transit(tab, wrows, fused.prepare_slant(G, F64), wgt)
    np.testing.assert_array_equal(
        got.numpy(), fused.transit_plain(tab, wrows, G, wgt).numpy())
    assert fused._transit_streamed(400) and not fused._transit_streamed(112)
