"""`multi_orb_slam_tpu_torch.parallel` against `multi_orb_slam_tpu.parallel`.

The JAX steps run on the conftest's virtual CPU mesh; the port's run on gloo
ranks of this host (`multihost.spawn_local`, `device="cpu"`, one process a
rank joined through a file store, one thread each), started once per world
size for the whole module.  The same seeded numpy problems go to both.

Tolerances: poses (`Tcw` entries) within 5e-4 of the JAX step at the same
world size, as `tests/test_dist_ba.py` holds 1 against 8 devices; the costs
before each outer iteration within 1e-3 relative (the first is the same sum
in another order, the later ones follow the iterates); points within 1e-3 m
(every point of `make_ba_problem` is observed several times, so none slides
far along its ray); fixed poses untouched to 1e-7; distributed scores within
1e-6 of the JAX scorer's.
"""

import io
import json
from contextlib import redirect_stdout

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from multi_orb_slam_tpu.parallel import dist_ba as ref_dist_ba
from multi_orb_slam_tpu.parallel import dist_placerec as ref_dist_placerec
from multi_orb_slam_tpu_torch import convert
from multi_orb_slam_tpu_torch.drivers import bench_dist_ba
from multi_orb_slam_tpu_torch.ops import orb
from multi_orb_slam_tpu_torch.parallel import dist_ba, dryrun, multihost

from test_dist_placerec import make_db
from test_local_ba import make_ba_problem

WORLDS = (1, 2, 4)
N_CAMS = (1, 2)
N_OUTER, CG_ITERS = 8, 30
TCW_TOL = 5e-4
COST_RTOL = 1e-3
POS_TOL = 1e-3
SCORE_TOL = 1e-6
DB_QUERY = 5


def problem(n_cams):
    """`make_ba_problem(n_pts=120)` as the `flatten_problem` inputs plus the
    calibration, numpy."""
    prob, _, _, T_rc, K, bf = make_ba_problem(n_pts=120, n_cams=n_cams)
    return dict(
        kf_Tcw=np.asarray(prob.kf_Tcw), kf_valid=np.asarray(prob.kf_valid),
        kf_free=np.asarray(prob.kf_free), kf_mp=np.asarray(prob.obs_mp),
        obs_uvr=np.asarray(prob.obs_uvr), obs_is2=np.asarray(prob.obs_inv_sigma2),
        mp_pos=np.asarray(prob.mp_pos), mp_valid=np.asarray(prob.mp_valid),
        T_rc=np.asarray(T_rc), K_intr=np.asarray(K), bf=np.asarray(bf))


def ref_flat(p, n):
    return ref_dist_ba.flatten_problem(*(p[k] for k in dryrun.FLAT_KEYS), n)


@pytest.fixture(scope="module")
def problems():
    return {c: problem(c) for c in N_CAMS}


@pytest.fixture(scope="module")
def db():
    ids, vals = make_db(K=32, B=64, n_words=5000)
    return np.asarray(ids), np.asarray(vals)


@pytest.fixture(scope="module")
def jax_runs(problems):
    """{(world, n_cams): (Tcw, pos, costs)} of the JAX step."""
    out = {}
    for n in WORLDS:
        mesh = Mesh(np.array(jax.devices()[:n]), ("data",))
        step = ref_dist_ba.make_dist_ba_step(mesh, n_outer=N_OUTER, cg_iters=CG_ITERS)
        for c, p in problems.items():
            Tcw, pos, costs = step(ref_flat(p, n), jnp.asarray(p["T_rc"]),
                                   jnp.asarray(p["K_intr"]), jnp.asarray(p["bf"]))
            out[n, c] = (np.asarray(Tcw), np.asarray(pos), np.asarray(costs))
    return out


@pytest.fixture(scope="module")
def port_runs(problems, db):
    """{world: [per-rank results of the module's calls]}: the BA of both
    problems on every world; the dry run at world 2; the scorer at world 4."""
    out = {}
    for n in WORLDS:
        calls = [(dryrun.run_ba, (problems[c], N_OUTER, CG_ITERS)) for c in N_CAMS]
        if n == 2:
            calls.append((dryrun.dryrun_multichip, (dryrun.dryrun_inputs(2),)))
        if n == 4:
            calls.append((dryrun.score_distributed, (*db, 5000, DB_QUERY)))
        out[n] = multihost.spawn_local(multihost.run_all, n, "gloo", "cpu", calls)
    return out


@pytest.mark.parametrize("n_cams", N_CAMS)
@pytest.mark.parametrize("n_shards", WORLDS)
def test_flatten_problem_bit_equal(problems, n_shards, n_cams):
    p = problems[n_cams]
    got = dist_ba.flatten_problem(*(p[k] for k in dryrun.FLAT_KEYS), n_shards)
    want = ref_flat(p, n_shards)
    assert len(got.obs_mp) % (128 * n_shards) == 0
    for f in dist_ba.FlatBA._fields:
        a, b = np.asarray(getattr(got, f)), np.asarray(getattr(want, f))
        assert a.dtype == b.dtype and np.array_equal(a, b), f


@pytest.mark.parametrize("n_cams", N_CAMS)
@pytest.mark.parametrize("world", WORLDS)
def test_dist_ba_matches_jax(port_runs, jax_runs, world, n_cams):
    Tcw_j, pos_j, costs_j = jax_runs[world, n_cams]
    r = port_runs[world][0][N_CAMS.index(n_cams)]
    assert r["world_size"] == world and r["backend"] == "gloo"
    np.testing.assert_allclose(r["Tcw"], Tcw_j, atol=TCW_TOL)
    np.testing.assert_allclose(r["costs"], costs_j, rtol=COST_RTOL)
    np.testing.assert_allclose(r["pos"], pos_j, atol=POS_TOL)


@pytest.mark.parametrize("n_cams", N_CAMS)
def test_world_one_matches_world_four(port_runs, n_cams):
    i = N_CAMS.index(n_cams)
    one, four = port_runs[1][0][i], port_runs[4][0][i]
    np.testing.assert_allclose(four["Tcw"], one["Tcw"], atol=TCW_TOL)
    np.testing.assert_allclose(four["pos"], one["pos"], atol=POS_TOL)


@pytest.mark.parametrize("n_cams", N_CAMS)
@pytest.mark.parametrize("world", (2, 4))
def test_ranks_hold_the_same_bits(port_runs, world, n_cams):
    """Poses, costs and the gathered points are replicated bit for bit."""
    i = N_CAMS.index(n_cams)
    ranks = [calls[i] for calls in port_runs[world]]
    for r in ranks[1:]:
        for k in ("Tcw", "costs", "pos"):
            assert np.array_equal(r[k], ranks[0][k]), k


@pytest.mark.parametrize("world", WORLDS)
def test_fixed_poses_untouched(port_runs, problems, world):
    for i, c in enumerate(N_CAMS):
        p, Tcw = problems[c], port_runs[world][0][i]["Tcw"]
        fixed = ~p["kf_free"]
        assert fixed.any()
        np.testing.assert_allclose(Tcw[fixed], p["kf_Tcw"][fixed], atol=1e-7)


@pytest.mark.parametrize("world", WORLDS)
def test_cost_falls(port_runs, world):
    for i in range(len(N_CAMS)):
        costs = port_runs[world][0][i]["costs"]
        assert np.all(np.diff(costs) <= 0) and costs[-1] < 1e-2 * costs[0], costs


def test_dist_scorer_matches_jax(port_runs, db):
    """World 4 of the port against the JAX scorer on 8 devices."""
    ids, vals = db
    mesh = Mesh(np.array(jax.devices()[:8]), ("data",))
    d_ids, d_vals = ref_dist_placerec.shard_database(mesh, jnp.asarray(ids), jnp.asarray(vals))
    want = np.asarray(ref_dist_placerec.make_dist_scorer(mesh, 5000)(
        jnp.asarray(ids[DB_QUERY]), jnp.asarray(vals[DB_QUERY]), d_ids, d_vals))
    for rank in port_runs[4]:
        got = rank[-1]
        np.testing.assert_allclose(got["scores"], want, rtol=SCORE_TOL, atol=SCORE_TOL)
        assert got["best"] == DB_QUERY and abs(got["scores"][DB_QUERY] - 1.0) < 1e-5
        assert got["score_err"] <= SCORE_TOL


def test_dryrun_world_two(port_runs):
    """The three stages at the reference's tiny shapes: each rank's features
    are the same frame's extraction in this process, the BA is finite and
    replicated, the scores are the whole table's."""
    inputs = dryrun.dryrun_inputs(2)
    ranks = [calls[-1] for calls in port_runs[2]]
    for r, res in enumerate(ranks):
        want = orb.extract_orb(torch.from_numpy(inputs["frames"][r]), inputs["orb_cfg"])
        for f, v in want._asdict().items():
            assert np.array_equal(res["features"][f], v.numpy()), (r, f)
        # the CPU takes the plain versions: no kernel launch is counted
        assert res["launches"] == {k: 0 for k in res["launches"]}
        assert np.isfinite(res["ba"]["Tcw"]).all() and np.isfinite(res["ba"]["pos"]).all()
        assert res["best"] == inputs["query"] and res["score_err"] <= SCORE_TOL
    assert np.array_equal(ranks[0]["ba"]["Tcw"], ranks[1]["ba"]["Tcw"])
    assert not np.array_equal(ranks[0]["features"]["xy"], ranks[1]["features"]["xy"])


def test_multihost_single_process(monkeypatch):
    for name in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(name, raising=False)
    multihost.initialize(device="cpu")      # no environment: nothing to join
    assert not torch.distributed.is_initialized()
    mesh = multihost.global_mesh(device="cpu")
    assert (mesh.world_size, mesh.rank, mesh.axis, mesh.group) == (1, 0, "data", None)
    assert mesh.device == torch.device("cpu")
    x = torch.arange(3.0)
    assert multihost.all_reduce_sum(x, mesh) is x and x.tolist() == [0.0, 1.0, 2.0]


def test_rank_failure_raises():
    """A rank that raises fails the call with its traceback; no rank is left."""
    with pytest.raises(RuntimeError, match="KeyError"):
        multihost.spawn_local(dryrun.dryrun_multichip, 2, "gloo", "cpu", {})


def test_bench_main_prints_json():
    buf = io.StringIO()
    with redirect_stdout(buf):
        rc = bench_dist_ba.main(["--devices", "2", "--device", "cpu", "--kfs", "8",
                                 "--points", "256", "--obs-per-kf", "32", "--outer", "2"])
    assert rc == 0
    out = json.loads(buf.getvalue().strip().splitlines()[-1])
    assert out["metric"] == "dist_gba_s_per_outer_iter" and out["devices"] == 2
    assert out["platform"] == "cpu" and out["backend"] == "gloo"
    assert (out["kfs"], out["points"]) == (8, 256) and out["value"] > 0
    assert out["cost_last"] < out["cost_first"]


def test_convert_carries_flat_ba(problems):
    """A reference `FlatBA` becomes the port's, field for field."""
    p = problems[2]
    got = convert.to_torch(ref_flat(p, 2), dist_ba.FlatBA, device="cpu")
    want = dist_ba.flatten_problem(*(p[k] for k in dryrun.FLAT_KEYS), 2)
    for f in dist_ba.FlatBA._fields:
        assert np.array_equal(getattr(got, f).numpy(), getattr(want, f)), f
