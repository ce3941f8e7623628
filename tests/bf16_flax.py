"""flax's bf16 evaluations of the articulated models, for the bf16 tests of
the port: in this process, under XLA's default flags, or in a fresh
interpreter with ``--xla_allow_excess_precision=false`` (nothing in aonerf
changes; the flag only reaches that interpreter's XLA).

    python -m tests.bf16_flax JOB.pkl OUT.pkl

runs the jobs a pickle holds (``run_fresh`` writes it) and pickles their
results.
"""

import os
import pickle
import subprocess
import sys
import tempfile

import numpy as np

SRC_HW = (48, 64)


def field_eval(tree, rays, latents, pts, latent_dense: bool, sc: int, nf: int, near=2.0, far=6.0,
               white=True, field_kwargs=None):
    """The bf16 ArticulatedNeRF's deterministic render of ``rays`` (comp,
    acc, depth per level) and each level's MLP on ``pts[level]`` (raw rgb,
    raw density), from the flax tree ``tree``."""
    import jax
    import jax.numpy as jnp

    from aonerf.models.articulated import ArticulatedNeRF, ArticulatedNeRFMLP
    from aonerf.ops.encoding import pos_enc

    kw = dict(field_kwargs or {})
    model = ArticulatedNeRF(num_coarse_samples=sc, num_fine_samples=nf, compute_dtype=jnp.bfloat16,
                            latent_dense=latent_dense, **kw)
    jr = {k: jnp.asarray(v) for k, v in rays.items()}
    jl = {k: jnp.asarray(v) for k, v in latents.items()}
    levels = jax.jit(lambda p, r, l: model.apply(p, r, False, white, near, far, l))(tree, jr, jl)
    mlp = ArticulatedNeRFMLP(compute_dtype=jnp.bfloat16, latent_dense=latent_dense,
                             embed_deg=kw.get("embed_deg", False))
    venc = pos_enc(jr["viewdirs"], 0, 4)
    raws = []
    for name, p in zip(("coarse_mlp", "fine_mlp"), pts):
        raws.append(jax.jit(lambda t, x, v, l: mlp.apply({"params": t}, x, v, l))(
            tree["params"][name], jnp.asarray(p), venc, jl))
    return jax.device_get({"levels": levels, "raws": raws})


def ae_eval(tree, rays, src, deg, latent_dense: bool, sc: int, nf: int, near=2.0, far=6.0, white=True):
    """The bf16 auto-encoder's deterministic forward: levels, codes and the
    predicted state."""
    import jax
    import jax.numpy as jnp

    from aonerf.models.ae import AutoEncoderArticulatedNeRF

    model = AutoEncoderArticulatedNeRF(num_coarse_samples=sc, num_fine_samples=nf, latent_dense=latent_dense,
                                       compute_dtype=jnp.bfloat16)
    levels, codes, state = jax.jit(lambda p, r, s, d: model.apply(p, r, s, d, False, white, near, far))(
        tree, {k: jnp.asarray(v) for k, v in rays.items()}, jnp.asarray(src), jnp.asarray(deg))
    return jax.device_get({"levels": levels, "codes": codes, "state": state})


def dense_eval(kernel, bias, x, dtype="bfloat16"):
    """flax's ``nn.Dense(dtype=dtype)`` on ``x``."""
    import flax.linen as nn
    import jax.numpy as jnp

    layer = nn.Dense(kernel.shape[1], dtype=getattr(jnp, dtype), param_dtype=jnp.float32)
    out = layer.apply({"params": {"kernel": jnp.asarray(kernel), "bias": jnp.asarray(bias)}},
                      jnp.asarray(x, getattr(jnp, dtype)))
    return np.asarray(out.astype(jnp.float32))


def latent_dense_eval(kernel, bias, x_var, latents, n_rows):
    """flax's ``_latent_dense`` in bf16 on ``x_var`` and the (V, C) latents."""
    import flax.linen as nn
    import jax.numpy as jnp

    from aonerf.models.articulated import _latent_dense

    class Layer(nn.Module):
        @nn.compact
        def __call__(self, x, lats):
            return _latent_dense(self, "layer", kernel.shape[1], x, lats, n_rows, jnp.bfloat16)

    out = Layer().apply({"params": {"layer": {"kernel": jnp.asarray(kernel), "bias": jnp.asarray(bias)}}},
                        jnp.asarray(x_var, jnp.bfloat16), [jnp.asarray(l) for l in latents])
    return np.asarray(out.astype(jnp.float32))


def conv_eval(kernel_hwio, x_nchw, stride, padding):
    """flax's ``nn.Conv(dtype=bfloat16, use_bias=False)`` on an NCHW input,
    returned NCHW."""
    import flax.linen as nn
    import jax.numpy as jnp

    conv = nn.Conv(kernel_hwio.shape[-1], kernel_hwio.shape[:2], strides=(stride, stride), padding=padding,
                   use_bias=False, dtype=jnp.bfloat16, param_dtype=jnp.float32)
    x = jnp.moveaxis(jnp.asarray(x_nchw, jnp.bfloat16), 1, -1)
    out = conv.apply({"params": {"kernel": jnp.asarray(kernel_hwio)}}, x)
    return np.asarray(jnp.moveaxis(out, -1, 1).astype(jnp.float32))


JOBS = {"field": field_eval, "ae": ae_eval, "dense": dense_eval, "latent_dense": latent_dense_eval,
        "conv": conv_eval}


def run_jobs(jobs):
    return [JOBS[name](*args, **kwargs) for name, args, kwargs in jobs]


def run_fresh(jobs, flags="--xla_allow_excess_precision=false"):
    """``run_jobs(jobs)`` in a fresh interpreter on the CPU with XLA_FLAGS
    ``flags`` and no compilation cache."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with tempfile.TemporaryDirectory() as tmp:
        job, out = os.path.join(tmp, "job.pkl"), os.path.join(tmp, "out.pkl")
        with open(job, "wb") as f:
            pickle.dump(jobs, f)
        env = {k: v for k, v in os.environ.items() if not k.startswith(("XLA_", "JAX_"))}
        env.update(JAX_PLATFORMS="cpu", XLA_FLAGS=flags, PYTHONPATH=root)
        subprocess.run([sys.executable, "-m", "tests.bf16_flax", job, out], cwd=root, env=env, check=True,
                       timeout=600)
        with open(out, "rb") as f:
            return pickle.load(f)


if __name__ == "__main__":
    import jax

    jax.config.update("jax_platforms", "cpu")
    with open(sys.argv[1], "rb") as f:
        results = run_jobs(pickle.load(f))
    with open(sys.argv[2], "wb") as f:
        pickle.dump(results, f)
