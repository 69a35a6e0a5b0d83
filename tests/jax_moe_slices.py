"""The slice-wise moe: the JAX package's ``moe_local`` on each (data
shard, model slice) of a batch, the aux losses averaged.

It is what the reference's expert-parallel ``moe_ep`` computes on a
D x M mesh (each data shard's rows, flattened and padded with zeros to
a multiple of M tokens, routed slice by slice with each slice's
capacity), on one device. ``tests/test_torch_mesh_train.py`` holds it
to JAX's ``moe_ep`` and patches it in for ``repro.models.moe.moe_apply``
to give the single-device step the meshed moe step is held to.
"""
import jax.numpy as jnp

from repro.models import moe as jmoe


def slicewise_moe(D: int, M: int):
    """A ``moe_apply`` (the reference's signature) over D data shards and
    M model slices."""
    def apply(params, x, cfg, mesh=None, **_):
        B, S, d = x.shape
        ys, auxs = [], []
        for xd in jnp.split(x, D):
            t = xd.shape[0] * S
            tm = -(-t // M)
            x2 = jnp.concatenate([xd.reshape(t, d),
                                  jnp.zeros((tm * M - t, d), x.dtype)])
            parts = []
            for m in range(M):
                y, aux = jmoe.moe_local(params, x2[m * tm:(m + 1) * tm][None],
                                        cfg)
                parts.append(y[0])
                auxs.append(aux)
            ys.append(jnp.concatenate(parts)[:t].reshape(xd.shape))
        return jnp.concatenate(ys), jnp.mean(jnp.stack(auxs))
    return apply
