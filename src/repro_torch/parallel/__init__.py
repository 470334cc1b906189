"""Sharding rules, activation constraints and cross-pod gradient compression
over the port's ``launch.mesh.Mesh`` (ports of ``repro.parallel``)."""
