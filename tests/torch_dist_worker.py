"""One rank of a gloo world running the sharded programs of
``cora_tpu_torch.parallel`` on the CPU (imports no JAX).

The tests start a world of N ranks of this script with :func:`run_world`
(rendezvous through a ``file://`` store under the test's temporary
directory, one thread per rank, a timeout on the whole world and on every
collective).  Every rank runs every case of its group (SPMD); rank 0
writes the gathered results to ``<out>/<cases>_w<N>.npz``, which the tests
hold against the port's world of 1 and against cora_tpu's sharded programs
on the same inputs (the input makers below are numpy, shared with the
tests).

    python tests/torch_dist_worker.py --rank R --world N --cases parallel \
        --out DIR
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# seconds a collective may take before it fails the rank
COLLECTIVE_TIMEOUT = 120


# --- inputs (numpy, shared with the tests) ---------------------------------

def corr(lmax, n):
    l = np.arange(lmax + 1, dtype=np.float64)
    cl = 1e-6 * (1.0 + l) ** -2.0
    x = np.linspace(0.0, 1.0, n)
    fc = np.exp(-0.5 * ((x[:, None] - x[None, :]) / 0.1) ** 2)
    return cl[:, None, None] * fc[None]


def roots(lmax, nz, seed):
    rng = np.random.RandomState(seed)
    return (rng.randn(lmax + 1, nz, nz) * 0.1).astype(np.float32)


def shells(nside, nchi, seed, amp=1.0):
    return amp * np.random.default_rng(seed).standard_normal((nchi, 12 * nside**2))


def fullsky_xi(L=24, nz=8, seed=17):
    """Complex standard normal ξ [L, nz, L] (ℓ, channel, m)."""
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((L, nz, L)) + 1j * rng.standard_normal((L, nz, L))) / np.sqrt(2)


def xi_table():
    """A correlation function as (r, ξ) spline data."""
    r = np.concatenate([[0.0], np.logspace(-2, 1, 64, endpoint=False),
                        np.linspace(10.0, 2500.0, 512)])
    return r, np.exp(-r / 60.0) / (1.0 + 0.05 * r)


def dynamics_fields(nchi=16, npix=192, seed=5):
    rng = np.random.default_rng(seed)
    phi, delta, delta_b = (rng.standard_normal((nchi, npix)) for _ in range(3))
    D = 0.5 + 0.5 * rng.random(nchi)
    frD = D * (0.4 + 0.2 * rng.random(nchi))
    K = rng.standard_normal((nchi, nchi))
    return phi, delta, delta_b, np.linspace(900.0, 1100.0, nchi), D, frD, K


def deposit_fields(nside=8, nchi=32, seed=8):
    npix = 12 * nside**2
    chi = np.linspace(900.0, 1000.0, nchi)
    rng = np.random.default_rng(seed)
    dchi = float(np.mean(np.diff(chi)))
    psi = np.stack([0.3 * dchi * rng.standard_normal((nchi, npix)),
                    2e-3 * rng.standard_normal((nchi, npix)),
                    2e-3 * rng.standard_normal((nchi, npix))])
    return psi, 0.1 * rng.standard_normal((nchi, npix)), \
        0.1 * rng.standard_normal((nchi, npix)), chi


def poison_fields(nside=4, nchi=16):
    npix = 12 * nside**2
    chi = np.linspace(900.0, 1000.0, nchi)
    psi = np.zeros((3, nchi, npix))
    psi[0] = 6.0 * float(np.mean(np.diff(chi)))  # ~6 bins: beyond a halo of 1
    return psi, np.zeros((nchi, npix)), np.zeros((nchi, npix)), chi


def zeldovich_fields(nside=8, nchi=16, seed=9):
    npix = 12 * nside**2
    rng = np.random.default_rng(seed)
    chi = np.linspace(1100.0, 900.0, nchi)  # descending, as frequency-ordered
    return (1e-2 * rng.standard_normal((nchi, npix)), 0.1 * rng.standard_normal((nchi, npix)),
            0.1 * rng.standard_normal((nchi, npix)), chi, 0.5 + 0.5 * rng.random(nchi),
            0.4 + 0.2 * rng.random(nchi))


SHOT_STD = 0.1 + np.random.default_rng(7).random(16)
CHAIN_FREQS = [500.0, 550.0, 16]


# --- the cases --------------------------------------------------------------

def _err(fn):
    try:
        fn()
    except (ValueError, RuntimeError) as e:
        return f"{type(e).__name__}: {e}"
    return "no error"


def parallel_cases(world, res):
    import torch

    from cora_tpu_torch.healpix import sht
    from cora_tpu_torch.parallel import distributed as pd
    from cora_tpu_torch.parallel import mesh as pm
    from cora_tpu_torch.signal import corrfunc

    m = pm.make_mesh(device="cpu")
    x = np.arange(8 * 6 * 4, dtype=np.float32).reshape(8, 6, 4)
    xs = pm.shard_over(x, m, axis=0)
    y = pm.redistribute(xs, m, axis=1)
    res["redistribute_local_shape"] = np.array(y.to_local().shape)
    res["redistribute"] = pm.redistribute(y, m, axis=0).full_tensor().numpy()

    for fh in (1, world):
        pod = pd.make_pod_mesh(freq_hosts=fh, device="cpu")
        res[f"pod_{fh}"] = np.array(pod.shape)
        res[f"pod_names_{fh}"] = np.array(pod.mesh_dim_names)
    res["pod_3"] = _err(lambda: pd.make_pod_mesh(freq_hosts=3, device="cpu"))
    res["init_cuda"] = _err(lambda: pd.initialize(device="cuda"))
    res["mesh_cuda"] = _err(lambda: pm.make_mesh(device="cuda"))
    res["mesh_size"] = _err(lambda: pm.make_mesh(world + 1, device="cpu"))

    nside, lmax = 16, 47
    r = roots(lmax, 16, 0)
    for mode, fchunk in (("cached", 3), ("scan", 2)):
        op = sht.get_sht(nside, lmax, legendre_mode=mode, device="cpu")
        cube = pm.synthesize_cube_sharded(op, op.tables(False), r, 5, m, fchunk=fchunk)
        res[f"cube_{mode}"] = cube.full_tensor().numpy()

    op = sht.get_sht(nside, lmax, legendre_mode="scan", device="cpu")
    r8 = roots(lmax, 8, 3)
    ms = pm.make_mesh(axis_name="sim", device="cpu")
    res["sims"] = pm.synthesize_cube_sims_sharded(
        op, op.tables(False), r8, 11, 4, ms, fchunk=4).full_tensor().numpy()
    if world == 4:
        m2 = pd.make_pod_mesh(freq_hosts=2, axis_names=("sim", "freq"), device="cpu")
        res["sims_2d"] = pm.synthesize_cube_sims_sharded(
            op, op.tables(False), r8, 11, 4, m2, fchunk=2, freq_axis="freq"
        ).full_tensor().numpy()

    c8 = corr(23, 8).astype(np.float32)
    res["fullsky"] = pm.mkfullsky_sharded(c8, 8, 23, 7, m).full_tensor().numpy()
    for name, dt in (("fullsky_xi", torch.complex64), ("fullsky_xi64", torch.complex128)):
        res[name] = pm.mkfullsky_sharded(c8, 8, 23, None, m, dtype=dt,
                                         xi=fullsky_xi()).full_tensor().numpy()
    res["clarray"] = corrfunc.corr_to_clarray(
        xi_table(), 23, np.linspace(900.0, 1100.0, 8), xromb=1, q=4, mesh=m).numpy()


# the 2-D program's operator (l_chunk 16: three re-seed bands, so the
# checkpoint rows are sliced too), key and fchunk (two or more chunks per
# rank in every layout); the reference's ξ is read from XI_2D in ``out``
SHT_2D = dict(nside=16, lmax=47, l_chunk=16)
KEY_2D, FCHUNK_2D, XI_2D = 5, 4, "xi_2d.npy"


def layouts_2d(world):
    """The (n_freq, n_band) pod meshes a world of ``world`` ranks runs."""
    return {1: [(1, 1)], 2: [(1, 2), (2, 1)], 4: [(2, 2), (1, 4)]}[world]


def parallel_2d_cases(world, res, out):
    import torch

    from cora_tpu_torch.healpix import sht
    from cora_tpu_torch.parallel import distributed as pd
    from cora_tpu_torch.parallel import mesh as pm

    op = sht.SHT(**SHT_2D, device="cpu", legendre_mode="scan")
    t = op.tables(False)
    r = roots(47, 16, 0)
    for nf, nb in layouts_2d(world):
        m = pd.make_pod_mesh(freq_hosts=nf, device="cpu")
        cube = pm.synthesize_cube_sharded_2d(op, t, r, KEY_2D, m, fchunk=FCHUNK_2D)
        res[f"cube_{nf}x{nb}"] = cube.full_tensor().numpy()
        res[f"local_{nf}x{nb}"] = cube.to_local().numpy()
        if world == 4 and nf == 2:  # the reference's ξ (written by the test)
            xi = np.load(os.path.join(out, XI_2D))
            res["cube_xi_2x2"] = pm.synthesize_cube_sharded_2d(
                op, t, r, None, m, fchunk=FCHUNK_2D, xi=xi).full_tensor().numpy()
        if world == 2:  # the reference's refusals, in the program itself
            res[f"odd_nz_{nf}x{nb}"] = _err(lambda: pm.synthesize_cube_sharded_2d(
                op, t, roots(47, 15, 0), KEY_2D, m))
            res[f"fchunk_{nf}x{nb}"] = _err(lambda: pm.synthesize_cube_sharded_2d(
                op, t, r, KEY_2D, m, fchunk=3))
    if world == 1:
        m = pm.make_mesh(device="cpu")
        res["cube_1d"] = pm.synthesize_cube_sharded(
            op, t, torch.from_numpy(r), KEY_2D, m, fchunk=FCHUNK_2D).full_tensor().numpy()


def lss_cases(world, res):
    from cora_tpu_torch.parallel import lss as pl
    from cora_tpu_torch.parallel import mesh as pm
    from cora_tpu_torch.signal import lss

    m = pm.make_mesh(device="cpu")
    full = lambda x: x.full_tensor().numpy()

    res["initial"] = full(pl.initial_lss_sharded(corr(23, 8), 8, 3, m))
    maps, chi8 = shells(8, 8, 4), np.linspace(900.0, 1100.0, 8)
    res["gradient"] = full(pl.gradient_sharded(maps, chi8, m))
    phi, delta, delta_b, chi, D, frD, K = dynamics_fields()
    res["linear"] = full(pl.linear_dynamics_sharded(phi, delta, delta_b, chi, D, frD, m))
    res["linear0"] = full(pl.linear_dynamics_sharded(phi, delta, delta_b, chi, D, None, m))
    res["fog"] = full(pl.fog_sharded(K, delta, m))
    res["shot"] = full(pl.shot_noise_sharded(11, SHOT_STD, (16, 192), m))

    psi, db, dm, chi = deposit_fields()
    res["za"] = full(pl.za_density_sph_sharded(psi, db, dm, chi, 8, m, halo=4))
    res["za_arith"] = full(pl.za_density_sph_sharded(psi, db, dm, chi, 8, m, halo=4,
                                                     vectors="arith"))
    res["za_desc"] = full(pl.za_density_sph_sharded(
        psi[:, ::-1].copy(), db[::-1].copy(), dm[::-1].copy(), chi[::-1].copy(), 8, m,
        halo=4))
    res["za_poison"] = full(pl.za_density_sph_sharded(*poison_fields(), 4, m, halo=1))
    res["za_stencil"] = _err(lambda: pl.za_density_sph_sharded(
        psi, db, dm, chi, 8, m, deposit="stencil"))
    phi, delta, delta_b, chi, D, fr = zeldovich_fields()
    res["zeldovich"] = full(pl.zeldovich_sharded(phi, delta, delta_b, chi, D, fr, 8, m,
                                                 halo=2))

    # the task chain with mesh_devices=-1 (unsharded in a world of 1)
    dev = {"device": "cpu"}
    cc = lss.CalculateCorrelations.from_config({"samples_per_decade": 100, **dev})
    cc.setup()
    aps = lss.CalculateMultiFrequencyAngularPowerSpectrum.from_config(
        {"nside": 8, "frequencies": CHAIN_FREQS, "xromb": 1, **dev}).process(cc.process())
    mesh = {"mesh_devices": -1, **dev}
    gen = lss.GenerateInitialLSSFromCl.from_config({"start_seed": 1, **mesh})
    gen.setup(aps)
    init = gen.process()
    bias = lss.GeneratePolynomialBias.from_config({"model": "HI", **dev})
    bias.setup()
    bf = bias.process(init)
    za = lss.ZeldovichDynamics.from_config({"sph": True, **mesh}).process(init, bf)
    lin = lss.LinearDynamics.from_config(mesh).process(init, bf)
    fog = lss.FingersOfGod.from_config({"model": "HI", **mesh})
    fog.setup()
    sm = fog.process(za)
    for k, v in (("initial_delta", init.delta), ("initial_phi", init.phi),
                 ("zeldovich", za.delta), ("linear", lin.delta), ("fog", sm.delta)):
        res[f"chain_{k}"] = v.numpy().copy()
    sm.delta.zero_()  # the shot noise alone (the task adds it in place)
    sn = lss.AddCorrelatedShotNoise.from_config({"log_M_HI_g": 10.0, "seed": 99, **mesh})
    sn.setup(init)
    res["chain_shot"] = sn.process(sm).delta.numpy()
    flat = lss.GenerateFlatSpectrumMap.from_config(
        {"nside": 4, "frequencies": [500.0, 550.0, 8], "variance": 2.0, "seed": 5,
         "pol": ["I", "Q"], **mesh})
    flat.setup()
    res["chain_flat"] = flat.process().map.numpy()

    ld = lss.LinearDynamics.from_config(mesh)
    res["get_mesh_cut"] = _err(lambda: ld._get_mesh(6))
    res["get_mesh_two"] = _err(
        lambda: lss.LinearDynamics.from_config({"mesh_devices": 2, **dev})._get_mesh(16))


def checkpoint_map(nside=4, nfreq=8):
    """The container the checkpoint cases save: a Map with ndarray and
    string attrs, a dataset attribute and its sky [nfreq, 1, npix]."""
    from cora_tpu_torch.core.containers import Map

    m = Map(polarisation=False, freq=np.linspace(400.0, 500.0, nfreq), nside=nside,
            device="cpu")
    m.attrs["tag"] = "testmap"
    m.attrs["vec"] = np.array([1.0, 2.0])
    m._dataset_attrs("map")["units"] = "K"
    sky = np.random.default_rng(0).standard_normal((nfreq, 1, 12 * nside**2))
    return m, sky


def checkpoint_tree():
    rng = np.random.default_rng(12)
    return {"x": np.arange(8 * 6, dtype=np.float64).reshape(8, 6),
            "y": rng.standard_normal((8, 8)).astype(np.float32),
            "host": np.linspace(0.0, 1.0, 5),
            "nested": {"z": np.arange(12, dtype=np.int64).reshape(3, 4)}}


def checkpoint_save_cases(world, res, ckpt):
    import torch

    from cora_tpu_torch.parallel import checkpoint as ck
    from cora_tpu_torch.parallel import mesh as pm

    m = pm.make_mesh(device="cpu")
    t = checkpoint_tree()
    tree = {"x": pm.shard_over(t["x"], m, 0), "y": pm.shard_over(t["y"], m, 1),
            "host": t["host"], "nested": {"z": torch.from_numpy(t["nested"]["z"])}}
    ck.save_sharded(os.path.join(ckpt, "tree"), tree)
    cont, sky = checkpoint_map()
    ck.save_container(os.path.join(ckpt, "map"), cont, arrays={"map": pm.shard_over(sky, m, 0)})
    res["files"] = np.array(sorted(os.listdir(os.path.join(ckpt, "tree"))))


def checkpoint_restore_cases(world, res, ckpt):
    import torch
    from torch.distributed.tensor import Shard

    from cora_tpu_torch.parallel import checkpoint as ck
    from cora_tpu_torch.parallel import mesh as pm

    m = pm.make_mesh(device="cpu")
    t = checkpoint_tree()
    like = ck.abstract_like(t, mesh=m, pspecs={"x": [Shard(1)], "y": [Shard(0)]})
    like["host"] = ck.abstract_like(t["host"])
    out = ck.restore_sharded(os.path.join(ckpt, "tree"), like)
    res["x"], res["y"] = out["x"].full_tensor().numpy(), out["y"].full_tensor().numpy()
    res["x_local_shape"] = np.array(out["x"].to_local().shape)
    res["host"] = out["host"]
    res["host_is_numpy"] = np.array(isinstance(out["host"], np.ndarray))
    res["z"] = out["nested"]["z"].full_tensor().numpy()
    plain = ck.restore_sharded(os.path.join(ckpt, "tree"),
                               {"x": torch.empty(8, 6, dtype=torch.float64)})
    res["x_plain"] = plain["x"].numpy()

    m3 = ck.load_container(os.path.join(ckpt, "map"), mesh=m, pspecs={"map": [Shard(2)]})
    res["map_sharded"] = m3["map"].full_tensor().numpy()
    res["map_local_shape"] = np.array(m3["map"].to_local().shape)
    m2 = ck.load_container(os.path.join(ckpt, "map"), device="cpu")
    res["map"] = m2["map"].numpy()
    res["map_class"] = np.array(type(m2).__module__ + "." + type(m2).__name__)
    res["map_tag"] = np.array(m2.attrs["tag"])
    res["map_vec"] = m2.attrs["vec"]
    res["map_units"] = np.array(m2._dataset_attrs("map")["units"])
    res["map_freq"] = m2.index_map["freq"]
    res["map_pol"] = m2.index_map["pol"]
    res["map_nside"] = np.array(m2.nside)


# the sims' (fleg, fchunk) levels: the reference's defaults (fleg = all
# local rows), a pair that agrees, a two-level pair and the finest pair
SIMS_LEVELS = {"none_4": (None, 4), "4_4": (4, 4), "8_2": (8, 2), "2_2": (2, 2)}


def sims_fleg_cases(world, res):
    import torch

    from cora_tpu_torch.healpix import sht
    from cora_tpu_torch.parallel import mesh as pm

    r8 = roots(47, 8, 3)
    ms = pm.make_mesh(axis_name="sim", device="cpu")
    for mode in ("scan", "cached"):
        op = sht.get_sht(16, 47, legendre_mode=mode, device="cpu")
        t = op.tables(False)
        for name, (fleg, fchunk) in SIMS_LEVELS.items():
            res[f"sims_{mode}_{name}"] = pm.synthesize_cube_sims_sharded(
                op, t, r8, 11, 2, ms, fchunk=fchunk, fleg=fleg).full_tensor().numpy()
    res["sims_fleg_3"] = _err(lambda: pm.synthesize_cube_sims_sharded(
        op, t, r8, 11, 2, ms, fchunk=1, fleg=3))
    # fchunk alone that does not divide the local rows: fleg defaults to all
    # of them, and there is no ragged last chunk
    res["sims_ragged_3"] = _err(lambda: pm.synthesize_cube_sims_sharded(
        op, t, r8, 11, 2, ms, fchunk=3))


CASES = {"parallel": parallel_cases, "parallel_2d": parallel_2d_cases, "lss": lss_cases,
         "sims_fleg": sims_fleg_cases, "checkpoint_save": checkpoint_save_cases,
         "checkpoint_restore": checkpoint_restore_cases}


# --- the world --------------------------------------------------------------

def run_world(world, cases, out, timeout=170, ckpt=None):
    """Run ``world`` ranks of this script on ``cases`` and return rank 0's
    results (a dict of arrays).  Raises with every rank's log when a rank
    fails or the world outlives ``timeout`` seconds (its ranks are killed)."""
    os.makedirs(out, exist_ok=True)
    rdv = os.path.join(out, f"rdv_{cases}_{world}")
    if os.path.exists(rdv):
        os.remove(rdv)
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    logs, procs = [], []
    for rank in range(world):
        log = open(os.path.join(out, f"{cases}_w{world}_r{rank}.log"), "w+")
        logs.append(log)
        cmd = [sys.executable, os.path.abspath(__file__), "--rank", str(rank), "--world",
               str(world), "--cases", cases, "--out", out, "--rdv", rdv]
        if ckpt:
            cmd += ["--ckpt", ckpt]
        procs.append(subprocess.Popen(cmd, env=env, stdout=log, stderr=subprocess.STDOUT))
    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            p.wait(timeout=max(1.0, deadline - time.monotonic()))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    text = []
    for rank, log in enumerate(logs):
        log.seek(0)
        text.append(f"--- rank {rank} (rc {procs[rank].returncode}) ---\n{log.read()[-4000:]}")
        log.close()
    if any(p.returncode != 0 for p in procs):
        raise RuntimeError(f"world of {world} ({cases}) failed or timed out after "
                           f"{timeout} s:\n" + "\n".join(text))
    with np.load(os.path.join(out, f"{cases}_w{world}.npz"), allow_pickle=False) as z:
        return {k: z[k] for k in z.files}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--world", type=int, required=True)
    ap.add_argument("--cases", choices=sorted(CASES), required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--rdv", required=True)
    ap.add_argument("--ckpt")
    a = ap.parse_args()

    from datetime import timedelta

    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    from cora_tpu_torch.parallel import distributed as pd

    pd.initialize(device="cpu", init_method="file://" + a.rdv, world_size=a.world,
                  rank=a.rank, timeout=timedelta(seconds=COLLECTIVE_TIMEOUT))
    res = {}
    try:
        fn = CASES[a.cases]
        if a.cases.startswith("checkpoint"):
            fn(a.world, res, a.ckpt)
        elif a.cases == "parallel_2d":
            fn(a.world, res, a.out)
        else:
            fn(a.world, res)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    if a.rank == 0:
        np.savez(os.path.join(a.out, f"{a.cases}_w{a.world}.npz"), **res)


if __name__ == "__main__":
    main()
