"""Drive the fit-and-serve path once on an NVIDIA GPU and check its answers.

Run from the repository root:

    python chip_smoke.py                # one GPU, every phase below
    python chip_smoke.py --four-cards   # only the multi-device path, 4 GPUs

Phases (one process; each prints its wall seconds and its comparisons with
the tolerance and the precision of each side; any failure exits non-zero
before the result line):

- device: the GPU's name and power limit, the JAX version, the device kind;
- kernels: the fused Pallas kernels, compiled for the card, against the
  plain XLA path at full f32, at the widths the engines use;
- exact-49k: ``GPRAS(model_type="exact").fit`` through the ``auto`` engine
  ladder on the multi-scale problem at N=49,152, D=8 (Hutchinson over the
  in-place super-panel Cholesky), held-out prediction, and the posterior
  mean against a float64 dense Cholesky solve on the card;
- cg-131k: the same problem at N=131,072 (the matrix-free CG engine), its
  matvec against the plain panel loop and its loss against the plain loss;
- serve: a full-field flood surrogate (49 events x 96 timesteps x 49,152
  cells): EOF fit, 50-mode SGPR fit, prediction, reverse transform with
  variance and the per-event metric suite, against a float64 posterior.

The last line of standard output is one JSON object,
``{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}``.
Without a GPU the script exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import time
from contextlib import contextmanager

import numpy as np

#: relative tolerances, each with the reason it is what it is
TOL = {
    # TF32x3 tensor-core contraction (~2^-21 per product) summed in a
    # different order over N terms, against full-f32 XLA: a few f32 ulps of
    # the largest entry, with room for sqrt(N) accumulation growth
    # (measured 3.9e-6 at N=131,072 on an H100)
    "kmv": 1e-4,
    # the lengthscale gradient is s + t - 2c, three f32 sums over N^2 terms
    # that cancel to a much smaller result; both sides are f32 (measured
    # 7.3e-5 at N=49,152 on an H100)
    "kgrad": 5e-4,
    # matrix-free prediction solves K alpha = y by preconditioned CG to a
    # 1e-6 relative residual; cond(K) ~ var/noise amplifies that into the
    # posterior mean, measured against the std of the float64 mean
    "exact_mean": 1e-3,
    # 32 unconverged, un-reorthogonalized f32 CG/Lanczos iterations amplify
    # last-bit matvec differences into the SLQ logdet (at fitted-like
    # conditioning on an H100, fused vs plain differed by 7.4e-4); the
    # phase also prints plain vs plain with another summation order
    "cg_loss": 2e-3,
    # f32 SGPR posterior (300 inducing points, jittered Cholesky of Kuu)
    # against the same posterior in float64, relative to each field's scale
    "sgpr_mean": 1e-3,
    "sgpr_var": 1e-2,
    # one device against four on the same loss: the sums run in another
    # order across devices, through the same 32 CG iterations
    "dist_cg": 1e-3,
    "dist_hutch": 1e-4,
    "dist_predict": 1e-3,
}


def log(msg: str) -> None:
    print(msg, flush=True)


@contextmanager
def phase(name: str):
    log(f"--- phase {name}")
    t0 = time.perf_counter()
    yield
    log(f"phase {name} seconds {time.perf_counter() - t0:.3f}")


def check(label: str, err: float, tol: float, precision: str) -> None:
    """Print one comparison and fail the run if it is out of tolerance."""
    ok = bool(np.isfinite(err) and err <= tol)
    log(f"compare {label}: rel_err {err:.3e} tol {tol:.0e} ({precision}) "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit(f"{label}: relative error {err:.3e} above {tol:.0e}")


def rel_max(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want)) / max(np.max(np.abs(want)), 1e-30))


def max_abs(got, want) -> float:
    return float(np.max(np.abs(np.asarray(got, np.float64)
                               - np.asarray(want, np.float64))))


def rel_tree(got: dict, want: dict) -> float:
    return max(rel_max(got[k], want[k]) for k in want)


def fit_like_params(d: int):
    """Hyperparameters near the hard problem's fitted values (var 1, noise
    1e-2, three active dims): the conditioning the engines meet after a
    fit, not at init."""
    import jax.numpy as jnp

    ls = np.full(d, 3.0)
    ls[:3] = (1.0, 0.5, 0.3)
    return {"log_variance": jnp.asarray(0.0, jnp.float32),
            "log_lengthscales": jnp.asarray(np.log(ls), jnp.float32),
            "log_noise_variance": jnp.asarray(math.log(1e-2), jnp.float32)}


def hard_data(n: int, d: int = 8):
    import jax.numpy as jnp

    from gpras_tpu.synthetic import hard_problem

    x, y = hard_problem(n, d)
    return jnp.asarray(x), jnp.asarray(y)


# ----------------------------------------------------------------- phases


def phase_device() -> dict:
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"no GPU: JAX's default device is {dev.platform!r}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    log(smi.stdout.strip().splitlines()[0])   # the card's name, power limit
    log(f"jax {jax.__version__} device_kind {dev.device_kind} "
        f"devices {len(jax.devices())} "
        f"bytes_limit {dev.memory_stats().get('bytes_limit')} "
        f"compile cache {jax.config.jax_compilation_cache_dir}")
    return {"platform": dev.platform, "kind": dev.device_kind,
            "count": len(jax.devices())}


def phase_kernels(n_kmv: int = 131072, r: int = 128, n_kgrad: int = 49152,
                  probes: int = 16, interpret: bool = False) -> None:
    """Each fused kernel against the plain XLA path at full f32."""
    import jax

    from gpras_tpu.gp.exact_cg import _cotangent_grads, kmv
    from gpras_tpu.ops import fused

    p = fit_like_params(8)
    x, _ = hard_data(n_kmv)
    v = jax.random.normal(jax.random.PRNGKey(1), (n_kmv, r), x.dtype)
    got = jax.jit(lambda x, v: fused.kmv("Matern52", p, x, v,
                                         interpret=interpret))(x, v)
    with fused.plain_xla(), jax.default_matmul_precision("highest"):
        want = jax.jit(lambda x, v: kmv("Matern52", p, x, v, 0.0))(x, v)
    check(f"kmv N={n_kmv} D=8 R={r} fused vs panel loop (max_abs_err "
          f"{max_abs(got, want):.3e})", rel_max(got, want),
          TOL["kmv"], "kernel: f32 distances + TF32x3 contraction; "
          "reference: XLA f32 'highest'")
    del x, v, got, want

    x, _ = hard_data(n_kgrad)
    ks = jax.random.split(jax.random.PRNGKey(2), 3)
    w = jax.random.normal(ks[0], (n_kgrad, probes), x.dtype)
    z = jax.random.rademacher(ks[1], (n_kgrad, probes), dtype=x.dtype)
    al = jax.random.normal(ks[2], (n_kgrad,), x.dtype)
    got = jax.jit(lambda *a: fused.kgrad("Matern52", p, *a, 1.0, 1.0 / probes,
                                         interpret=interpret))(x, w, z, al)
    with fused.plain_xla(), jax.default_matmul_precision("highest"):
        want = jax.jit(lambda x, w, z, al: _cotangent_grads(
            "Matern52", p, x, al, w, z, 1.0, 1.0 / probes, 4096))(x, w, z, al)
    err = max(rel_max(got[k], want[k]) for k in got)
    abs_err = max(max_abs(got[k], want[k]) for k in got)
    check(f"kgrad N={n_kgrad} D=8 m={probes} fused vs Gram-vjp panel loop "
          f"(max_abs_err {abs_err:.3e})", err, TOL["kgrad"],
          "kernel: f32 distances + TF32x3 cotangent; "
          "reference: XLA f32 'highest'")


def _fit_exact(n: int, n_test: int, steps: int, engine_expected: str):
    from gpras_tpu import GPRAS

    x, y = hard_data(n + n_test)
    model = GPRAS("Matern52", model_type="exact")
    t0 = time.perf_counter()
    model.fit(x[:n], y[:n], optimization_method="adam", max_iter=steps,
              learning_rate=0.02)
    losses = np.asarray(model.fit_info["losses"], np.float64).ravel()
    log(f"fit N={n} engine {model.fit_info['engine']} losses "
        f"{losses.tolist()} seconds {time.perf_counter() - t0:.3f}")
    if model.fit_info["engine"] != engine_expected:
        raise SystemExit(f"engine {model.fit_info['engine']!r}, expected "
                         f"{engine_expected!r}")
    if not (np.all(np.isfinite(losses)) and losses[-1] < losses[0]):
        raise SystemExit(f"losses not finite and decreasing: {losses}")
    return model, x[n:], y[n:]


def phase_exact(n: int = 49152, n_test: int = 8192, steps: int = 3) -> None:
    import jax
    import jax.numpy as jnp

    from gpras_tpu.ops import kernels as K
    from gpras_tpu.ops import linalg

    model, xq, _ = _fit_exact(n, n_test, steps, "hutchinson")
    t0 = time.perf_counter()
    mean, var = model.predict(xq)
    log(f"predict {xq.shape[0]} points seconds {time.perf_counter() - t0:.3f}")
    if not (np.all(np.isfinite(mean)) and np.all(var > 0)):
        raise SystemExit("non-finite predictive mean or non-positive variance")

    # float64 dense Cholesky posterior mean at the fitted hyperparameters
    p64 = {k: jnp.asarray(v[0], jnp.float64) for k, v in model.params.items()}
    x64 = jnp.asarray(model.x, jnp.float64)
    y64 = jnp.asarray(model.y[:, 0], jnp.float64)

    # the same noise + relative jitter diagonal the f32 engines factorize
    jitter = linalg.default_jitter(jnp.float32)

    @jax.jit
    def mean64(p, x, y, xq):
        noise = jnp.exp(p["log_noise_variance"]) + jitter * jnp.exp(
            p["log_variance"])
        kmat = K.gram("Matern52", p, x) + noise * jnp.eye(x.shape[0],
                                                           dtype=x.dtype)
        chol = jnp.linalg.cholesky(kmat)
        alpha = jax.scipy.linalg.cho_solve((chol, True), y)
        return K.gram("Matern52", p, xq, x) @ alpha

    want = np.asarray(mean64(p64, x64, y64, jnp.asarray(xq, jnp.float64)))
    err = float(np.sqrt(np.mean((mean[:, 0] - want) ** 2)) / np.std(want))
    check(f"exact N={n} posterior mean (RMSE / std) vs float64 dense Cholesky",
          err, TOL["exact_mean"], "model: f32 matrix-free CG predict; "
          "reference: float64")


def phase_cg(n: int = 131072, steps: int = 2, probes: int = 16) -> None:
    import jax

    from gpras_tpu.gp.exact_cg import kmv, make_cg_training_loss
    from gpras_tpu.ops import fused

    model, _, _ = _fit_exact(n, 0, steps, "cg")
    p = {k: v[0] for k, v in model.params.items()}
    x, y = model.x, model.y[:, 0]
    v = jax.random.normal(jax.random.PRNGKey(3), (n, probes + 1), x.dtype)
    noise = 1e-2
    got = jax.jit(lambda x, v: kmv("Matern52", p, x, v, noise))(x, v)
    with fused.plain_xla(), jax.default_matmul_precision("highest"):
        want = jax.jit(lambda x, v: kmv("Matern52", p, x, v, noise))(x, v)
    check(f"cg N={n} matvec R={probes + 1} vs panel loop", rel_max(got, want),
          TOL["kmv"], "kernel: TF32x3; reference: XLA f32 'highest'")

    key = jax.random.PRNGKey(0)
    loss = make_cg_training_loss("Matern52", probes=probes, precond_rank=64)
    got = float(jax.jit(lambda p: loss(p, x, y, key))(p))
    with fused.plain_xla():
        loss_p = make_cg_training_loss("Matern52", probes=probes,
                                       precond_rank=64)
        want = float(jax.jit(lambda p: loss_p(p, x, y, key))(p))
        loss_q = make_cg_training_loss("Matern52", probes=probes,
                                       precond_rank=64, row_panel=2048)
        other = float(jax.jit(lambda p: loss_q(p, x, y, key))(p))
    log(f"cg N={n} loss plain row_panel 4096 vs 2048 (summation order "
        f"only): rel_diff {abs(other - want) / abs(want):.3e}")
    check(f"cg N={n} loss fused vs plain matvec ({got:.4f} vs {want:.4f})",
          abs(got - want) / abs(want), TOL["cg_loss"],
          "both f32 package policy")


def phase_serve(events: tuple[int, int] = (35, 14), timesteps: int = 96,
                grid: tuple[int, int] = (256, 192), max_modes: int = 50,
                n_inducing: int = 300, iters: int = 50) -> None:
    import jax
    import jax.numpy as jnp

    from gpras_tpu import GPRAS, PreProcessor
    from gpras_tpu.gp import sgpr
    from gpras_tpu.metrics import compute_event_metrics
    from gpras_tpu.synthetic import flood_fields

    n_tr, n_te = events
    hf, lf, elev = flood_fields(n_tr + n_te, timesteps, grid)
    split = n_tr * timesteps
    log(f"fields {hf.shape[0]} samples x {hf.shape[1]} cells "
        f"({hf.nbytes / 1e9:.2f} GB per fidelity)")

    def eof(fields):
        pre = PreProcessor(hydraulic_parameter="depth", wet_threshold=0.03)
        pre.fit(fields[:split], elev)
        if pre.spatial_mode_count > max_modes:   # North's rule, capped
            pre.fit(fields[:split], elev, spatial_mode_count=max_modes)
        return pre

    t0 = time.perf_counter()
    hf_pre, lf_pre = eof(hf), eof(lf)
    y_tr = hf_pre.transform(hf[:split])
    x_tr, x_te = lf_pre.transform(lf[:split]), lf_pre.transform(lf[split:])
    log(f"EOF modes hf {hf_pre.spatial_mode_count} lf "
        f"{lf_pre.spatial_mode_count} seconds {time.perf_counter() - t0:.3f}")

    model = GPRAS("Matern52", model_type="sgpr")
    t0 = time.perf_counter()
    model.fit(x_tr, y_tr, n_inducing=n_inducing, optimization_method="adam",
              max_iter=iters, learning_rate=0.01)
    losses = np.asarray(model.fit_info["losses"], np.float64)
    log(f"sgpr fit {y_tr.shape[1]} modes seconds "
        f"{time.perf_counter() - t0:.3f}")
    if not np.all(np.isfinite(losses[:, :iters])):
        raise SystemExit("non-finite SGPR training loss")

    t0 = time.perf_counter()
    mean, var = model.predict(x_te)
    field, field_var = hf_pre.reverse_transform(mean, var)
    log(f"predict + reverse_transform {field.shape} seconds "
        f"{time.perf_counter() - t0:.3f}")

    truth = hf_pre.wse_2_depth(hf[split:])
    t0 = time.perf_counter()
    rmse = []
    for e in range(n_te):
        rows = slice(e * timesteps, (e + 1) * timesteps)
        m = compute_event_metrics(jnp.asarray(truth[rows]),
                                  jnp.asarray(field[rows]),
                                  jnp.asarray(np.sqrt(field_var[rows])))
        rmse.append(float(m["rmse_aoi_toi"]))
    log(f"event metrics {n_te} events, depth RMSE per event "
        f"{np.round(rmse, 4).tolist()} seconds {time.perf_counter() - t0:.3f}")
    if not np.all(np.isfinite(rmse)):
        raise SystemExit("non-finite event metrics")

    p64 = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), model.params)
    x64 = jnp.asarray(x_tr, jnp.float64)
    y64 = jnp.asarray(y_tr, jnp.float64)
    mean64, var64 = jax.jit(jax.vmap(
        lambda p, y_i: sgpr.predict("Matern52", p, x64, y_i,
                                    jnp.asarray(x_te, jnp.float64),
                                    include_noise=True),
        in_axes=(0, 1)))(p64, y64)
    check("serve SGPR mean vs float64 posterior", rel_max(mean, mean64.T),
          TOL["sgpr_mean"], "model: f32; reference: float64")
    check("serve SGPR variance vs float64 posterior", rel_max(var, var64.T),
          TOL["sgpr_var"], "model: f32; reference: float64")


def phase_four_cards(n_cg: int = 131072, n_hutch: int = 81920,
                     n_query: int = 64, steps: int = 2) -> None:
    """The multi-device exact fit and sharded prediction, each against the
    single-device result of the same loss, gradient and posterior.

    The Hutchinson case runs at N=81,920: its one-device reference holds the
    Gram and its factor (2 x 26.8 GB), which is about as large as one card
    takes (exact_stochastic.DENSE_BYTES_PER_ENTRY); the (2, 2) mesh holds
    6.7 GB of Gram per card."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from gpras_tpu import GPRAS
    from gpras_tpu.gp.exact_cg import make_cg_nlml
    from gpras_tpu.gp.exact_stochastic import make_hutchinson_nlml
    from gpras_tpu.parallel import make_mesh
    from gpras_tpu.parallel.pcg import make_dist_cg_nlml
    from gpras_tpu.parallel.pexact import make_dist_nlml_stochastic
    from gpras_tpu.parallel.ppredict import sharded_predict

    n_dev = len(jax.devices())
    if n_dev < 4:
        raise SystemExit(f"--four-cards needs 4 devices, found {n_dev}")
    key = jax.random.PRNGKey(0)
    mesh1 = make_mesh((4,), ("i",))
    mesh2 = make_mesh((2, 2), ("i", "j"))
    cases = [("cg", n_cg, "auto", TOL["dist_cg"]),
             ("hutchinson", n_hutch, mesh2, TOL["dist_hutch"])]
    for engine, n, mesh, tol in cases:
        x, y = hard_data(n + n_query)
        xq, x, y = x[n:], x[:n], y[:n]
        p = fit_like_params(8)
        t0 = time.perf_counter()
        model = GPRAS("Matern52", model_type="exact", exact_engine=engine)
        model.fit(x, y, mesh=mesh, optimization_method="adam",
                  max_iter=steps, learning_rate=0.02)
        losses = np.asarray(model.fit_info["losses"], np.float64).ravel()
        log(f"dist fit {engine} N={n} engine {model.fit_info['dist_engine']} "
            f"mesh {model.fit_info['dist_mesh_shape']} losses "
            f"{losses.tolist()} seconds {time.perf_counter() - t0:.3f}")
        if not (np.all(np.isfinite(losses)) and losses[-1] < losses[0]):
            raise SystemExit(f"distributed losses not finite and "
                             f"decreasing: {losses}")

        # the same loss and gradient on one device vs the mesh
        if engine == "cg":
            xs = jax.device_put(x, NamedSharding(mesh1, P("i")))
            dist, _ = make_dist_cg_nlml(mesh1, "Matern52", probes=16,
                                        max_iters=32, precond_rank=64)
            single = make_cg_nlml("Matern52", probes=16, max_iters=32,
                                  precond_rank=64)
        else:
            xs = jax.device_put(x, NamedSharding(mesh2, P("i")))
            dist = make_dist_nlml_stochastic(
                mesh2, "Matern52", b=GPRAS._dist_block(n, mesh2), probes=16)
            # the super-panel engine with wide panels, which compiles in
            # seconds where the narrow default takes a minute
            single = make_hutchinson_nlml("Matern52", probes=16,
                                          chol="super", chol_w=4096,
                                          chol_strip=16384)
        t0 = time.perf_counter()
        vd, gd = jax.jit(jax.value_and_grad(
            lambda p: dist(p, xs, y, key)))(p)
        vd = float(vd)
        td = time.perf_counter() - t0
        dev0 = jax.devices()[0]
        x0, y0 = jax.device_put(x, dev0), jax.device_put(y, dev0)
        t0 = time.perf_counter()
        vs, gs = jax.jit(jax.value_and_grad(
            lambda p: single(p, x0, y0, key)))(p)
        vs = float(vs)
        log(f"{engine} N={n} loss 4 devices {vd:.4f} ({td:.1f} s) vs one "
            f"{vs:.4f} ({time.perf_counter() - t0:.1f} s)")
        check(f"{engine} N={n} loss, mesh vs one device",
              abs(vd - vs) / abs(vs), tol, "both f32 package policy")
        check(f"{engine} N={n} gradient, mesh vs one device",
              rel_tree(gd, gs), tol * 10, "both f32 package policy")
        del x0, y0

        t0 = time.perf_counter()
        mean_d, var_d = sharded_predict(mesh1, model, xq)
        mean_s, var_s = model.predict(xq)
        log(f"sharded_predict {n_query} queries seconds "
            f"{time.perf_counter() - t0:.3f} (with the one-device predict)")
        check(f"{engine} N={n} sharded vs one-device posterior mean",
              rel_max(mean_d, mean_s), TOL["dist_predict"], "both f32")
        check(f"{engine} N={n} sharded vs one-device posterior variance",
              rel_max(var_d, var_s), TOL["dist_predict"], "both f32")
        del model, xs


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the multi-device path (needs 4 GPUs)")
    args = ap.parse_args(argv)
    if args.four_cards:
        # the one-device Hutchinson reference holds 53.7 GB (Gram + factor)
        os.environ.setdefault("XLA_PYTHON_CLIENT_MEM_FRACTION", "0.9")

    import jax

    jax.config.update("jax_enable_x64", True)   # float64 references
    from gpras_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    with phase("device"):
        device = phase_device()
    if args.four_cards:
        with phase("four-cards"):
            phase_four_cards()
    else:
        with phase("kernels"):
            phase_kernels()
        with phase("exact-49k"):
            phase_exact()
        with phase("cg-131k"):
            phase_cg()
        with phase("serve"):
            phase_serve()
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
