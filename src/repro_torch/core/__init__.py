"""The port's copies of ``repro.core``'s framework-free modules (link
fabric and scheduler, traffic plans, state controller, failure detection, the
paper's analytic models, FCR), ``core/consistency.py`` on the port's tree
utilities, and the checkpoint razor's plan (``razor.py``) and the in-step
neighbour backup (``instant.py``) over the port's specs and meshes."""
