"""Activation sharding constraints (port of ``repro.parallel.constraints``).

The reference's ``constrain`` asks XLA's sharding propagation to place an
activation (``jax.lax.with_sharding_constraint``) and no-ops without a mesh.
Eager PyTorch has no sharding propagation: every tensor is this rank's own,
so ``constrain`` returns its input. The collectives that the reference's
propagation would insert are explicit in the port: the FSDP gathers in
``models.modes.unshard_layer_params``, the gradient reduce-scatter, the
params' all-gather and the neighbor backup in ``train.step.build_train_step``,
all through ``launch.mesh.Mesh``.
"""
from __future__ import annotations

BATCH = ("pod", "data")  # logical batch axes (pod may be absent)


def constrain(x, *parts):
    """constrain(x, ("pod","data"), "model", None): ``x`` itself."""
    return x
