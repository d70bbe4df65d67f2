"""SVGP streaming-fit throughput at archive scale (N far beyond dense).

The minibatch engine (gp/svgp.py) never materializes anything N-shaped, so a
single chip trains on datasets the exact ladder cannot touch at any setting.
This script measures epochs of minibatch NGD+Adam on a synthetic archive —
generated ON DEVICE (host->device transfer of an N-sized array would
dominate and measure the transfer, not the math).

Per-epoch work: (N // B) steps, each one Kuu Cholesky (M^3/3) + the (M, B)
cross-Gram/projection matmuls + the conjugate NGD update.

Run: ``python benchmarks/svgp_throughput.py`` (GPU; CPU works at small sizes)
Knobs: GPRAS_SVGP_N (default 1_048_576), GPRAS_SVGP_M (512),
GPRAS_SVGP_B (8192), GPRAS_SVGP_D (8), GPRAS_SVGP_EPOCHS (3, timed after one
warmup epoch program run ... the same compiled program, so warm = steady
state), GPRAS_SVGP_NATGRAD (0.5; 0 disables NGD).

GPRAS_SVGP_STREAM=1: the archive lives in HOST memory
(numpy) and minibatches stream host->device in GPRAS_SVGP_CHUNK-batch
chunks (default 16) through gp/svgp.make_stream_fit — the realistic bound
for a parquet-resident archive, where host->device transfer is the
bound. The device-resident number is the compute upper bound.
"""

from __future__ import annotations

import json
import os
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

from gpras_tpu.utils.compile_cache import enable_compile_cache  # noqa: E402

enable_compile_cache()


def stream_main(n, m, b, d, epochs, ng, x, y, params) -> dict:
    """Host-streamed epoch: archive in host numpy, chunked host->device
    minibatch streaming (gp/svgp.make_stream_fit). The host shuffles (as a
    parquet reader would), ships GPRAS_SVGP_CHUNK batches per transfer, and
    overlaps the next chunk's device_put with the current chunk's scan
    (async dispatch; only the final loss is fetched)."""
    import numpy as np

    import jax
    import jax.numpy as jnp

    from gpras_tpu.gp import svgp

    chunk = int(os.environ.get("GPRAS_SVGP_CHUNK", "16"))
    # archive on HOST (numpy) — the realistic starting point
    x_h = np.asarray(x)
    y_h = np.asarray(y)
    del x, y

    init, run_chunk = svgp.make_stream_fit(
        "Matern52", learning_rate=0.005, natgrad=ng if ng > 0 else None)
    opt_state = init(params)

    nb = n // b
    n_chunks = nb // chunk
    rng = np.random.default_rng(0)

    def chunks_of(epoch_seed: int):
        order = rng.permutation(n)[: n_chunks * chunk * b]
        xs = x_h[order].reshape(n_chunks, chunk, b, d)
        ys = y_h[order].reshape(n_chunks, chunk, b, 1)
        for i in range(n_chunks):
            yield xs[i], ys[i]

    # warmup: compile/load on one chunk (discarded state)
    xc0 = jnp.zeros((chunk, b, d), jnp.float32)
    yc0 = jnp.zeros((chunk, b, 1), jnp.float32)
    _, _, l0 = run_chunk(params, opt_state, xc0, yc0, n)
    float(l0[-1])

    t0 = time.perf_counter()
    p, s = params, opt_state
    losses = None
    for ep in range(epochs):
        # prefetch pipeline: device_put the next chunk while the current
        # chunk's scan is in flight (dispatch is async; no per-chunk sync)
        pending = None
        for xc, yc in chunks_of(ep):
            nxt = (jax.device_put(jnp.asarray(xc)),
                   jax.device_put(jnp.asarray(yc)))
            if pending is not None:
                p, s, losses = run_chunk(p, s, *pending, n)
            pending = nxt
        p, s, losses = run_chunk(p, s, *pending, n)
    final_loss = float(losses[-1])  # sync
    dt = time.perf_counter() - t0

    steps = epochs * n_chunks * chunk
    out = {
        "n": n, "m": m, "batch": b, "epochs": epochs, "natgrad": ng,
        "stream": True, "chunk_batches": chunk,
        "fit_seconds": round(dt, 3),
        "seconds_per_epoch": round(dt / epochs, 3),
        "steps_per_sec": round(steps / dt, 2),
        "points_per_sec": round(steps * b / dt, 1),
        "bytes_per_sec": round(steps * b * (d + 1) * 4 / dt, 1),
        "final_epoch_loss": round(final_loss, 2),
        "platform": jax.devices()[0].platform,
    }
    print(json.dumps(out))
    return out


def main() -> dict:
    import jax
    import jax.numpy as jnp

    from gpras_tpu.gp import svgp

    n = int(os.environ.get("GPRAS_SVGP_N", str(1 << 20)))
    m = int(os.environ.get("GPRAS_SVGP_M", "512"))
    b = int(os.environ.get("GPRAS_SVGP_B", "8192"))
    d = int(os.environ.get("GPRAS_SVGP_D", "8"))
    epochs = int(os.environ.get("GPRAS_SVGP_EPOCHS", "3"))
    ng = float(os.environ.get("GPRAS_SVGP_NATGRAD", "0.5"))

    # synthetic archive generated on device: smooth response + noise
    @jax.jit
    def make_data(key):
        kx, ke = jax.random.split(key)
        x = jax.random.normal(kx, (n, d), jnp.float32)
        y = (jnp.sin(2.0 * x[:, 0]) + 0.5 * jnp.tanh(x[:, 1] * x[:, 2])
             + 0.05 * jax.random.normal(ke, (n,), jnp.float32))
        return x, y

    x, y = make_data(jax.random.PRNGKey(0))
    z = x[:m]
    params = svgp.init_params("Matern52", x, z, noise_variance=0.1)

    if os.environ.get("GPRAS_SVGP_STREAM", "0") == "1":
        return stream_main(n, m, b, d, epochs, ng, x, y, params)

    fit = svgp.make_minibatch_fit(
        "Matern52", batch_size=b, epochs=epochs, learning_rate=0.005,
        natgrad=ng if ng > 0 else None)

    # compile/load (one program for the whole multi-epoch fit), discarded
    p_warm, hist = fit(params, x, y, jax.random.PRNGKey(1))
    float(hist[-1])  # scalar fetch = the sync barrier in this environment

    t0 = time.perf_counter()
    p_fit, hist = fit(params, x, y, jax.random.PRNGKey(2))
    final_loss = float(hist[-1])  # sync
    dt = time.perf_counter() - t0

    steps = epochs * (n // b)
    out = {
        "n": n, "m": m, "batch": b, "epochs": epochs, "natgrad": ng,
        "fit_seconds": round(dt, 3),
        "seconds_per_epoch": round(dt / epochs, 3),
        "steps_per_sec": round(steps / dt, 2),
        "points_per_sec": round(steps * b / dt, 1),
        "final_epoch_loss": round(final_loss, 2),
        "platform": jax.devices()[0].platform,
    }
    del p_warm, p_fit
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
