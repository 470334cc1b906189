"""The simulated cluster with real training on the port's model
(``cluster.py``), its recovery policies (``recovery.py``) and the port's own
copies of ``repro.runtime``'s framework-free modules."""
