"""Sharding rules, activation constraints, cross-pod gradient compression
and the GPipe pipeline over the port's ``launch.mesh.Mesh`` (ports of
``repro.parallel``)."""
from repro_torch.parallel.pipeline import bubble_fraction, pipeline_forward

__all__ = ["bubble_fraction", "pipeline_forward"]
