"""Checkpoint storage, chunked state streams and the checkpoint engine, on
the port's tree utilities (``repro_torch.tree``): the same ``.npz`` keys and
chunk manifests as ``repro.ckpt`` for the same state."""
