"""SVGP accuracy north star at archive scale.

The throughput benchmark proves the minibatch engine's speed; this one proves
its ANSWERS at a scale the exact ladder cannot audit directly. Protocol
(N = 2^20 train by default, 8,192 held-out test, the svgp_throughput DGP —
sin(2 x0) + 0.5 tanh(x1 x2) + 0.05 eps in 8-D):

1. Gold: collapsed SGPR (gp/sgpr.py — the reference's own engine family,
   gpras/gpr.py:293-299). Hyperparameters are fit on a 65,536-point uniform
   subsample with the collapsed bound (full-batch Adam; the bound is exact,
   no minibatch noise), then the collapsed-OPTIMAL variational posterior at
   those hyperparameters is computed over the FULL N (svgp.optimal_q — one
   (M, N) whitened projection, no AD, ~2 GB at M=512/N=2^20; Titsias: this
   is exactly the SGPR posterior).

   CAVEAT: this gold is HANDICAPPED — its
   hyperparameters see only the 65k subsample while SVGP's see the full
   archive, so "SVGP beats the gold" partly measures that handicap.
   GPRAS_SVGP_GOLD_CG=1 adds the UNHANDICAPPED anchor: hyperparameters
   from an honest full-N matrix-free cg fit (gp/coldfit.fit_exact —
   residual-gated, preconditioned, host-linesearch L-BFGS) at
   GPRAS_SVGP_GOLD_CG_N=131,072 points — a size the exact ladder can
   audit — then the same collapsed-optimal posterior over the full N
   (``gold131k_*`` fields).
2. SVGP: gp/svgp.make_minibatch_fit from standard init (conjugate NGD on q
   at lr 0.5 + Adam on hyperparameters), GPRAS_SVGP_ACC_EPOCHS epochs
   (default 8) over the full device-resident archive.
3. Report held-out RMSE vs the true latent f and vs the noisy y for both,
   the SVGP-vs-gold mean RMSE, and 2-sigma coverage of held-out y
   (nominal ~0.954) for both.

bench.py runs it in-run with GPRAS_BENCH_SVGP_ACC=1.

Run: ``python benchmarks/svgp_accuracy.py`` (GPU; small-N CPU smoke via
GPRAS_SVGP_N / GPRAS_SVGP_ACC_SUB).
"""

from __future__ import annotations

import json
import os
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

os.environ.setdefault("JAX_COMPILATION_CACHE_DIR", str(REPO / ".jax_cache"))


def main() -> dict:
    import numpy as np

    import jax
    import jax.numpy as jnp
    import optax

    from gpras_tpu.gp import sgpr, svgp

    n = int(os.environ.get("GPRAS_SVGP_N", str(1 << 20)))
    m = int(os.environ.get("GPRAS_SVGP_M", "512"))
    b = int(os.environ.get("GPRAS_SVGP_B", "8192"))
    d = int(os.environ.get("GPRAS_SVGP_D", "8"))
    n_test = int(os.environ.get("GPRAS_SVGP_ACC_TEST", "8192"))
    n_sub = min(n, int(os.environ.get("GPRAS_SVGP_ACC_SUB", "65536")))
    epochs = int(os.environ.get("GPRAS_SVGP_ACC_EPOCHS", "8"))
    hyper_steps = int(os.environ.get("GPRAS_SVGP_ACC_HYPER_STEPS", "300"))
    kernel = "Matern52"

    @jax.jit
    def make_data(key):
        kx, ke = jax.random.split(key)
        x = jax.random.normal(kx, (n + n_test, d), jnp.float32)
        f = jnp.sin(2.0 * x[:, 0]) + 0.5 * jnp.tanh(x[:, 1] * x[:, 2])
        y = f + 0.05 * jax.random.normal(ke, (n + n_test,), jnp.float32)
        return x, f, y

    x_all, f_all, y_all = make_data(jax.random.PRNGKey(0))
    x, y = x_all[:n], y_all[:n]
    x_t, f_t, y_t = x_all[n:], f_all[n:], y_all[n:]
    z = x[:m]

    t0 = time.perf_counter()

    # --- 1. gold hyperparameters: collapsed SGPR on a uniform subsample ---
    stride = max(1, n // n_sub)
    x_s, y_s = x[::stride], y[::stride]
    p_gold = sgpr.init_params(kernel, x_s, z, noise_variance=0.1)
    opt = optax.adam(0.02)

    @jax.jit
    def hyper_fit(p):
        s = opt.init(p)

        def step(carry, _):
            p, s = carry
            loss, g = jax.value_and_grad(
                lambda pp: sgpr.training_loss(kernel, pp, x_s, y_s))(p)
            u, s = opt.update(g, s, p)
            return (optax.apply_updates(p, u), s), loss

        (p, _), losses = jax.lax.scan(step, (p, s), None, length=hyper_steps)
        return p, losses[-1]

    p_gold, gold_loss = hyper_fit(p_gold)
    float(gold_loss)  # sync
    t_gold_hyper = time.perf_counter() - t0

    # --- collapsed-optimal posterior at gold hypers over the FULL N ---
    p_gold_q = dict(p_gold)
    p_gold_q["q_mu"] = jnp.zeros((m, 1), jnp.float32)
    p_gold_q["q_raw"] = jnp.zeros((1, m, m), jnp.float32)
    opt_q = jax.jit(lambda p: svgp.optimal_q(kernel, p, x, y))
    p_gold_q = opt_q(p_gold_q)
    gold_mu, gold_var = svgp.predict(kernel, p_gold_q, x_t)
    gold_mu_h = np.asarray(gold_mu)
    gold_sd_h = np.sqrt(np.asarray(gold_var))
    t_gold = time.perf_counter() - t0

    # --- 2. SVGP minibatch fit from standard init ---
    p0 = svgp.init_params(kernel, x, z, noise_variance=0.1)
    # lr 0.01: the hyperparameter log-leaves must travel ~4-5 log-units
    # (noise 0.1 -> ~0.0025) within epochs * (N/B) steps; NGD handles q
    fit = svgp.make_minibatch_fit(kernel, batch_size=b, epochs=epochs,
                                  learning_rate=0.01, natgrad=0.5)
    t1 = time.perf_counter()
    p_fit, hist = fit(p0, x, y, jax.random.PRNGKey(1))
    svgp_loss = float(hist[-1])  # sync
    t_svgp = time.perf_counter() - t1

    svgp_mu, svgp_var = svgp.predict(kernel, p_fit, x_t)
    svgp_mu_h = np.asarray(svgp_mu)
    svgp_sd_h = np.sqrt(np.asarray(svgp_var))

    f_h, y_h = np.asarray(f_t), np.asarray(y_t)

    def rmse(a, bb):
        return float(np.sqrt(np.mean((a - bb) ** 2)))

    def cov2(mu, sd):
        return float(np.mean(np.abs(y_h - mu) <= 2.0 * sd))

    # --- optional unhandicapped gold: full-N cg-fit hyperparameters ---
    gold_cg: dict = {}
    if os.environ.get("GPRAS_SVGP_GOLD_CG", "0") == "1":
        from gpras_tpu.gp.coldfit import fit_exact
        from gpras_tpu.gp.exact_stochastic import dense_n_max

        n_cg = min(n, int(os.environ.get("GPRAS_SVGP_GOLD_CG_N", "131072")))
        t2 = time.perf_counter()
        # noise-plateau stop is a host-linesearch CG-path knob; tiny-N CPU
        # smokes fall below CG_THRESHOLD and use the plateau rule instead
        stop_dec = (float(os.environ.get("GPRAS_SVGP_GOLD_CG_STOP", "25"))
                    if n_cg > dense_n_max() else None)
        p_cg, info_cg = fit_exact(kernel, x[:n_cg], y[:n_cg],
                                  max_iter=int(os.environ.get(
                                      "GPRAS_SVGP_GOLD_CG_ITERS", "40")),
                                  stop_decrease=stop_dec)
        p_cg_q = {
            "z": z,
            "q_mu": jnp.zeros((m, 1), jnp.float32),
            "q_raw": jnp.zeros((1, m, m), jnp.float32),
            **{k: jnp.asarray(v) for k, v in p_cg.items()},
        }
        p_cg_q = opt_q(p_cg_q)
        cg_mu, cg_var = svgp.predict(kernel, p_cg_q, x_t)
        cg_mu_h = np.asarray(cg_mu)
        cg_sd_h = np.sqrt(np.asarray(cg_var))
        gold_cg = {
            "gold131k_n_fit": n_cg,
            "gold131k_rmse_f": round(rmse(cg_mu_h, f_h), 5),
            "gold131k_rmse_y": round(rmse(cg_mu_h, y_h), 5),
            "gold131k_coverage_2sd": round(cov2(cg_mu_h, cg_sd_h), 4),
            "gold131k_fit_seconds": round(time.perf_counter() - t2, 1),
            "gold131k_stopped_by": str(info_cg.get("stopped_by")),
            "gold131k_noise_sigma": round(float(np.exp(
                0.5 * np.asarray(p_cg["log_noise_variance"]))), 5),
            "svgp_vs_gold131k_mean_rmse": round(rmse(svgp_mu_h, cg_mu_h), 5),
        }

    out = {
        "n": n, "m": m, "n_test": n_test, "n_sub": n_sub, "epochs": epochs,
        "kernel": kernel,
        "svgp_rmse_f": round(rmse(svgp_mu_h, f_h), 5),
        "gold_rmse_f": round(rmse(gold_mu_h, f_h), 5),
        "svgp_rmse_y": round(rmse(svgp_mu_h, y_h), 5),
        "gold_rmse_y": round(rmse(gold_mu_h, y_h), 5),
        "svgp_vs_gold_mean_rmse": round(rmse(svgp_mu_h, gold_mu_h), 5),
        "svgp_coverage_2sd": round(cov2(svgp_mu_h, svgp_sd_h), 4),
        "gold_coverage_2sd": round(cov2(gold_mu_h, gold_sd_h), 4),
        "noise_sigma_true": 0.05,
        "svgp_noise_sigma": round(
            float(np.exp(0.5 * np.asarray(p_fit["log_noise_variance"]))), 5),
        "gold_hyper_seconds": round(t_gold_hyper, 1),
        "gold_total_seconds": round(t_gold, 1),
        "svgp_fit_seconds": round(t_svgp, 1),
        "platform": jax.devices()[0].platform,
        **gold_cg,
    }
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
