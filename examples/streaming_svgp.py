"""Streaming surrogate training with the SVGP backend.

When the training archive outgrows memory (decades of gauge records, synthetic
storm catalogs with 10^6+ events), the collapsed SGPR bound — which touches
every training point each optimizer step — stops being an option. The SVGP
backend (gp/svgp.py) trains on minibatches at O(M^2) memory, and its fitted
variational state IS the model: serving never needs the training set.

This example shows the production recipe on a synthetic flood archive:

1. fit an SGPR on a subsample (fast, collapsed bound),
2. convert it to an SVGP warm start with ``optimal_q`` (the conjugate optimum
   of the uncollapsed bound — the two models are then EXACTLY equivalent),
3. refine on the full archive with minibatch natural-gradient + Adam steps,
4. compare held-out accuracy: SVGP-on-everything vs SGPR-on-the-subsample.

Run: ``python examples/streaming_svgp.py`` (CPU or GPU; small sizes, seconds).
"""

from __future__ import annotations

import numpy as np


def make_archive(n_events: int, n_features: int = 6, seed: int = 0):
    """A nonlinear storm-response archive: features -> peak-stage target."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n_events, n_features)).astype(np.float32)
    y = (np.sin(2.0 * x[:, 0]) + 0.5 * np.tanh(x[:, 1] * x[:, 2])
         + 0.2 * x[:, 3] + 0.05 * rng.normal(size=n_events))
    return x, y.astype(np.float32)


def main(n_events: int = 4096, n_sub: int = 512, n_inducing: int = 48,
         sgpr_iters: int = 150, epochs: int = 20, batch_size: int = 256,
         verbose: bool = True):
    import jax
    import jax.numpy as jnp

    from gpras_tpu.fit import optimizers as fitters
    from gpras_tpu.gp import sgpr, svgp

    x_np, y_np = make_archive(n_events + 512)
    x, y = jnp.asarray(x_np[:n_events]), jnp.asarray(y_np[:n_events])
    x_te, y_te = x_np[n_events:], y_np[n_events:]

    # 1. SGPR on a subsample (the collapsed bound needs all N in memory,
    #    so production would cap this stage at what one chip holds)
    stride = max(1, n_events // n_sub)
    x_sub, y_sub = x[::stride], y[::stride]
    z0 = x_sub[:n_inducing]
    p_sgpr = sgpr.init_params("Matern52", x_sub, z0, noise_variance=0.1)
    p_sgpr, _ = fitters.adam_fit(
        lambda p: sgpr.training_loss("Matern52", p, x_sub, y_sub),
        p_sgpr, max_iter=sgpr_iters, learning_rate=0.02)

    # 2. convert: same hyperparameters + the conjugate-optimal q over the
    #    subsample — at this point SVGP == SGPR exactly (tests/test_svgp.py)
    p_svgp = dict(p_sgpr)
    p_svgp["q_mu"] = jnp.zeros((n_inducing, 1), x.dtype)
    p_svgp["q_raw"] = jnp.zeros((1, n_inducing, n_inducing), x.dtype)
    p_svgp = svgp.optimal_q("Matern52", p_svgp, x_sub, y_sub)

    # 3. refine on the FULL archive: minibatch NGD-on-q + Adam-on-hypers,
    #    the whole fit one jitted scan program (no host round trips)
    fit = svgp.make_minibatch_fit("Matern52", batch_size=batch_size,
                                  epochs=epochs, learning_rate=0.005,
                                  natgrad=0.5)
    p_ref, hist = fit(p_svgp, x, y, jax.random.PRNGKey(0))

    # 4. held-out comparison (SVGP predicts from params alone)
    m_sub, _ = sgpr.predict("Matern52", p_sgpr, x_sub, y_sub,
                            jnp.asarray(x_te))
    m_ref, v_ref = svgp.predict("Matern52", p_ref, jnp.asarray(x_te))
    rmse_sub = float(np.sqrt(np.mean((np.asarray(m_sub) - y_te) ** 2)))
    rmse_ref = float(np.sqrt(np.mean((np.asarray(m_ref) - y_te) ** 2)))
    sigma = np.sqrt(np.asarray(v_ref))
    cover = float(np.mean(np.abs(np.asarray(m_ref) - y_te) <= 2.0 * sigma))

    if verbose:
        print(f"archive: {n_events} events; SGPR subsample: {x_sub.shape[0]}; "
              f"M={n_inducing}; {epochs} epochs x batch {batch_size}")
        print(f"held-out RMSE: SGPR-on-subsample {rmse_sub:.4f}  ->  "
              f"SVGP-on-archive {rmse_ref:.4f}")
        print(f"2-sigma coverage: {cover:.3f}; "
              f"final epoch loss {float(hist[-1]):.2f}")
    return rmse_sub, rmse_ref, cover


if __name__ == "__main__":
    main()
